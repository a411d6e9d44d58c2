"""dsf_tpu_torch.utils (counterpart of dsf_tpu/utils)."""
