"""Data parallelism for the training step (port of ``vits_tpu/parallel``'s
data-parallel half): one process a card, PyTorch DDP over NCCL."""
