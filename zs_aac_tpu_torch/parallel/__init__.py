"""Multi-GPU: process groups, data parallelism and Megatron tensor parallelism."""
