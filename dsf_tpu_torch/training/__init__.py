"""dsf_tpu_torch.training (counterpart of dsf_tpu/training)."""
