"""Multi-GPU: process start-up (``distributed``) and the (data x fsdp)
layout of the ranks (``mesh``); counterpart of dsf_tpu/parallel/."""
