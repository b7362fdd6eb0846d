"""Measurement tools of the port, each run as ``python -m
optflow_tpu_torch.tools.<name>``: ``kernel_ablate`` (what the TV-L1 iteration
spends on each class of cost) and ``smem_cap`` (how much shared memory a
thread block really gets)."""
