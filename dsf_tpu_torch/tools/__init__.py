"""dsf_tpu_torch.tools (counterpart of dsf_tpu/tools)."""
