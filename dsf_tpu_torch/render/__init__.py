"""dsf_tpu_torch.render (counterpart of dsf_tpu/render)."""

from dsf_tpu_torch.render.renderer import Renderer, synth_sample, render_params, mask_img  # noqa: F401
