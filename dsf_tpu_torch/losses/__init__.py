"""dsf_tpu_torch.losses (counterpart of dsf_tpu/losses)."""
