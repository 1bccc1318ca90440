"""Measurement tools of the port: the dot-walk probes (``dot_decompose``,
``mosaic_probe``), the train-step profiler (``profile_step``) and the
fused-MLP kernel bench (``bench_kernel``).  Each runs as
``python -m plnerf_torch.tools.<name>`` on the CUDA device, or is called
as a function with ``device="cpu"`` (plain versions, CPU times)."""
