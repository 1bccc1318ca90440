"""The kernel build cache (plnerf_torch/kernels/build.py): a library's
name carries a hash of its source and of the headers beside it, so an
edit to either builds anew.  Runs without nvcc: nothing is compiled."""
import os
import shutil

from plnerf_torch.kernels import build


def test_library_path_covers_source_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert "fused_mlp_fwd" in names and "fused_mlp_bwd" in names
    before = {n: build.library_path(n, str(csrc)) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = csrc / "sgemm_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, str(csrc)) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "fused_mlp_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("fused_mlp_fwd", str(csrc)) != \
        after["fused_mlp_fwd"]
    assert build.library_path("fused_mlp_bwd", str(csrc)) == \
        after["fused_mlp_bwd"]


def test_wgmma_header_edit_rebuilds_every_library(tmp_path):
    """wgmma_core.cuh (the bf16 forward's and the probes' wgmma code) is
    covered like every header: an edit gives every library a new path."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert "dot_probe" in names
    before = {n: build.library_path(n, str(csrc)) for n in names}
    header = csrc / "wgmma_core.cuh"
    for src in ("fused_mlp_fwd.cu", "dot_probe.cu"):
        assert '#include "wgmma_core.cuh"' in (csrc / src).read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(build.library_path(n, str(csrc)) != before[n] for n in names)
