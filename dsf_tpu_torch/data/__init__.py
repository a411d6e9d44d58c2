"""dsf_tpu_torch.data (counterpart of dsf_tpu/data)."""
