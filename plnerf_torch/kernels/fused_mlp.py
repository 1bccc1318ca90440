"""Fused NeRF-MLP: the wrappers around the hand-written CUDA kernels
``csrc/fused_mlp_fwd.cu`` and ``csrc/fused_mlp_bwd.cu`` (which replace the
TPU kernels ``_kernel`` and ``_bwd_kernel`` of
``plnerf/kernels/fused_mlp.py``), their weight packing, their plain
PyTorch versions, and the autograd function around both.

``apply`` dispatches on the device of its input: a CPU tensor runs the
plain versions, a CUDA tensor launches the kernels or raises.  There is no
fallback from one to the other.

Packed layout (``pack_weights``; the CUDA source's header lists it too):
every block is ``[K, N]`` row-major, K and N padded with zeros to
multiples of ``ALIGN`` = 32 (input 63 -> 64, views 27 -> 32; not to the
TPU's 128 lanes).  A layer fed by a concat is two blocks, ``a @ Wa +
b @ Wb``: the skip layer (rows split at ``input_ch``) and the split
schedule's views layer (rows split at ``netwidth``).  feature|alpha are
N-merged, alpha in the column right after the feature block.  The folded
schedule (``fold_heads``) uses the exact fold ``Wfv = Wf @ Wv1[:W]``,
``bfv = bf @ Wv1[:W] + bv`` computed in fp32 before any cast, N-merged
with the alpha column; its view block spans the same N.  The bf16
kernels (tensor cores, ``wgmma``) read the blocks as one stream of
shared-memory slab images in the order they consume them: the forward
``wgmma_stream`` (applied by ``PackedMLP.flat``), the backward's data
pass ``bwd_stream`` (images of W for the recompute, of W^T for the data
grads); the fp32 forward and backward read every block row-major (the
fp32 backward transposes them itself); the plain versions read the same
blocks as ``[K, N]`` matrices.  The fp32 forward walks the points in
chunks of at most ``FWD_CHUNK`` (``fwd_chunks``), which bounds its
activation workspace.

Topology rules kept from the JAX wrapper: softplus10 is applied outside
the kernel, a final-layer skip goes to the unfused ``apply_mlp``, any
leading shape is flattened and views are broadcast (per-ray views
``[R, 1, ch]`` go to the kernel unbroadcast, with a samples-per-ray
divisor; their grad is the sum of the per-point ``dv`` over a ray's
samples).  Under autograd the viewdirs topology backpropagates through the
backward kernel (or ``backward_plain`` on the CPU), whose packed grads are
unpadded, unfolded and handed to each ``nn.Linear``; the plain topology
backpropagates through ``apply_mlp``, as the JAX wrapper does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import ModelConfig
from ..core.mlp import NeRF, apply_mlp, softplus10_density
from . import build

ALIGN = 32
SPLIT, FOLDED, PLAIN = 0, 1, 2
# points per fp32 forward launch sequence: two fp32 activation buffers of
# FWD_CHUNK x w_p (4 GB at w_p = 256) whatever the request's size
FWD_CHUNK = 1 << 21
# the bf16 forward's k-slab (rows of one shared-memory image) and its
# widest column pass (csrc/fused_mlp_fwd.cu KC, MAX_PASS)
SLAB_K, MAX_PASS = 32, 256
KERNEL = "fused_mlp_fwd"
BWD_KERNEL = "fused_mlp_bwd"

# CUDA launches made by ``forward_cuda`` and ``backward_cuda`` (chip_smoke.py
# resets and reads them to show that a render or a train step went through
# the kernels), and of those backward calls the fp32 ones given the
# activations their forward kept (``bwd_saved``).  A
# launch recorded into a CUDA graph runs nothing and is not counted; a
# graph's replays run no Python, and their launches are counted in a
# device trace (``utils/profile.trace_kernel_counts``)
launches = 0
bwd_launches = 0
bwd_saved = 0


def _rup(x: int, m: int = ALIGN) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class PackedMLP:
    """Padded weight blocks in kernel order; ``weights`` in the compute
    dtype, ``biases`` fp32."""
    head: int
    n_layers: int
    skip_mask: int      # bit i: layer i is fed by the [x | h] concat
    in_ch: int
    vch: int
    in_p: int
    w_p: int
    v_p: int
    h_p: int
    dtype: torch.dtype
    weights: List[torch.Tensor]
    biases: List[torch.Tensor]

    def flat(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward kernel's weight buffer (fp32 blocks row-major, bf16
        the ``wgmma_stream``, gathered by one index per layout) and its
        bias buffer."""
        w = torch.cat([w.reshape(-1) for w in self.weights])
        if self.dtype == torch.bfloat16:
            w = w[_stream_index(self, w.device)]
        return w, torch.cat([b.reshape(-1) for b in self.biases])


def _passes(n: int, kept: int) -> List[Tuple[int, int]]:
    """(first column, width) of the bf16 kernel's column passes over a
    product of ``n`` columns whose first ``kept`` stay on chip
    (csrc/fused_mlp_fwd.cu ``for_each_pass``): the columns that go only to
    raw, 32 at a time, then the kept ones as one pass (at most
    ``MAX_PASS`` wide)."""
    out = [(c0, ALIGN) for c0 in range(kept, n, ALIGN)]
    return out + ([(0, kept)] if kept else [])


_STREAM_INDEX: dict = {}


def _stream_index(p: "PackedMLP", device: torch.device,
                  stream=None) -> torch.Tensor:
    """Positions in the row-major block buffer of the elements of
    ``stream(p)`` (``wgmma_stream`` unless given: the forward's; the
    backward's is ``bwd_stream``), per stream, layout and device (built
    once, from element ids, on the host; copied to a card from pinned
    memory without waiting on it)."""
    stream = stream or wgmma_stream
    key = (stream.__name__, p.head, p.n_layers, p.skip_mask, p.in_p, p.w_p,
           p.v_p, p.h_p, str(device))
    if key not in _STREAM_INDEX:
        ids, off = [], 0
        for shape in _block_shapes(p)[0]:
            n = shape[0] * shape[1]
            ids.append(torch.arange(off, off + n,
                                    dtype=torch.float64).reshape(shape))
            off += n
        idx = stream(dataclasses.replace(p, weights=ids)).long()
        if torch.device(device).type == "cuda":
            idx = idx.pin_memory()
        _STREAM_INDEX[key] = idx.to(device, non_blocking=True)
    return _STREAM_INDEX[key]


def _block_shapes(p: "PackedMLP"
                  ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """The [K, N] shape of every weight block and the length of every bias
    of ``pack_weights``'s layout, in its order, from the layout's integers
    alone."""
    ws, bs = [], []
    for i in range(p.n_layers):
        if (p.skip_mask >> i) & 1:
            ws += [(p.in_p, p.w_p), (p.w_p, p.w_p)]
        else:
            ws.append((p.in_p if i == 0 else p.w_p, p.w_p))
        bs.append(p.w_p)
    if p.head == SPLIT:
        ws += [(p.w_p, p.w_p + ALIGN), (p.w_p, p.h_p), (p.v_p, p.h_p),
               (p.h_p, ALIGN)]
        bs += [p.w_p + ALIGN, p.h_p, ALIGN]
    elif p.head == FOLDED:
        ws += [(p.w_p, p.h_p + ALIGN), (p.v_p, p.h_p + ALIGN), (p.h_p, ALIGN)]
        bs += [p.h_p + ALIGN, ALIGN]
    else:
        ws.append((p.w_p, ALIGN))
        bs.append(ALIGN)
    return ws, bs


def _unflat(p: "PackedMLP", wbuf: torch.Tensor, bbuf: torch.Tensor
            ) -> "PackedMLP":
    """The blocks of ``PackedMLP.flat``'s two buffers (the inverse of
    ``flat``; bf16 undoes the ``wgmma_stream`` order)."""
    if p.dtype == torch.bfloat16:
        rm = torch.empty_like(wbuf)
        rm[_stream_index(p, wbuf.device)] = wbuf
        wbuf = rm
    wshapes, bsizes = _block_shapes(p)
    ws = torch.split(wbuf, [k * n for k, n in wshapes])
    return dataclasses.replace(
        p, weights=[w.view(s) for w, s in zip(ws, wshapes)],
        biases=list(torch.split(bbuf, bsizes)))


def _products(p: "PackedMLP") -> List[Tuple[List[int], int, int]]:
    """(indices of the weight blocks summed, output columns, columns kept
    on chip) of every product of the forward, in the order the kernels run
    them (csrc/fused_mlp_fwd.cu ``build_plan``)."""
    walk, hb = _layer_blocks(p)
    prods = [([bh] if bx is None else [bx, bh], p.w_p, p.w_p)
             for bx, bh in walk]
    if p.head == SPLIT:
        return prods + [([hb], p.w_p + ALIGN, p.w_p),
                        ([hb + 1, hb + 2], p.h_p, p.h_p), ([hb + 3], ALIGN, 0)]
    if p.head == FOLDED:
        return prods + [([hb, hb + 1], p.h_p + ALIGN, p.h_p),
                        ([hb + 2], ALIGN, 0)]
    return prods + [([hb], ALIGN, 0)]


def wgmma_image(w: torch.Tensor) -> torch.Tensor:
    """The shared-memory image of one k-slab ``w`` [32, NP] as the bf16
    kernel's wgmma reads its B operand: K-major (W^T, NP rows of 32 values,
    64 bytes), in the 64-byte swizzle: the 16-byte group g (values
    8g .. 8g + 7) of row n stored at group position g ^ ((n >> 1) & 3)."""
    k, n = w.shape
    rows = w.t().reshape(n, k // 8, 8)
    g = torch.arange(k // 8, device=w.device)
    swz = g[None, :] ^ ((torch.arange(n, device=w.device)[:, None] >> 1) & 3)
    return rows.gather(1, swz[:, :, None].expand(n, k // 8, 8)).reshape(-1)


def wgmma_stream(p: "PackedMLP") -> torch.Tensor:
    """Every weight block as the bf16 forward kernel streams it: for each
    product, each column pass (``_passes``), each summed block, each 32-row
    k-slab, its ``wgmma_image``, in that order.  A permutation of the
    blocks."""
    out = []
    for blocks, n, kept in _products(p):
        for c0, width in _passes(n, kept):
            for b in blocks:
                w = p.weights[b]
                for k0 in range(0, w.shape[0], SLAB_K):
                    out.append(wgmma_image(w[k0:k0 + SLAB_K, c0:c0 + width]))
    return torch.cat(out)


def _bwd_products(p: "PackedMLP"
                  ) -> List[Tuple[List[Tuple[int, str, int, int]], int]]:
    """(terms, NP) of every product of the bf16 backward's data pass, in
    the order csrc/fused_mlp_bwd.cu ``build_dplan`` runs them, each one
    column pass of NP columns.  A term ``(block, mode, k0, K)`` streams K
    / 32 slabs of weight block ``block``: mode ``"f"`` (recompute, A @ W)
    the rows [k0, k0 + K) and columns [0, NP) of W, mode ``"d"`` (data
    grad, dA @ W^T) the rows [0, NP) and columns [k0, k0 + K) of W,
    transposed."""
    walk, hb = _layer_blocks(p)
    w, h, i, v = p.w_p, p.h_p, p.in_p, p.v_p
    prods = [(([] if bx is None else [(bx, "f", 0, i)])
              + [(bh, "f", 0, i if k == 0 else w)], w)
             for k, (bx, bh) in enumerate(walk)]
    if p.head == SPLIT:
        waf, wvf, wvv, wr = range(hb, hb + 4)
        prods += [([(waf, "f", 0, w)], w),                      # feature
                  ([(wvf, "f", 0, w), (wvv, "f", 0, v)], h),    # z_hv
                  ([(wr, "d", 0, ALIGN)], h),                   # da_v
                  ([(wvv, "d", 0, h)], v),                      # dv
                  ([(wvf, "d", 0, h)], w),                      # dfeat
                  ([(waf, "d", 0, w), (waf, "d", w, ALIGN)], w)]
    else:
        wfa, wvv, wr = range(hb, hb + 3)
        prods += [([(wfa, "f", 0, w), (wvv, "f", 0, v)], h),    # z_hv
                  ([(wr, "d", 0, ALIGN)], h),                   # da_v
                  ([(wvv, "d", 0, h), (wvv, "d", h, ALIGN)], v),  # dv
                  ([(wfa, "d", 0, h), (wfa, "d", h, ALIGN)], w)]
    for k in range(p.n_layers - 1, -1, -1):                     # dx, da
        bx, bh = walk[k]
        if bx is not None:
            prods.append(([(bx, "d", 0, w)], i))
        prods.append(([(bh, "d", 0, w)], w if k > 0 else i))
    return prods


def bwd_stream(p: "PackedMLP") -> torch.Tensor:
    """Every weight slab the bf16 backward's data pass reads, in the order
    it reads them (``_bwd_products``): per product, term and 32-row
    k-slab, the ``wgmma_image`` of the slab's [32, NP] operand."""
    out = []
    for terms, n in _bwd_products(p):
        for b, mode, k0, k in terms:
            w = p.weights[b]
            for s in range(k0, k0 + k, SLAB_K):
                out.append(wgmma_image(w[s:s + SLAB_K, :n] if mode == "f"
                                       else w[:n, s:s + SLAB_K].t()))
    return torch.cat(out)


def _wb(layer: torch.nn.Linear) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] fp32 weight and fp32 bias of a torch Linear."""
    return layer.weight.detach().float().t(), layer.bias.detach().float()


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))


def _pad1(b: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(b, (0, n - b.shape[0]))


def pack_weights(model: NeRF, cfg: ModelConfig, dtype=torch.float32,
                 fold_heads: bool = False, vch: Optional[int] = None
                 ) -> PackedMLP:
    """Port of the JAX ``_padded_weights`` for the CUDA kernel's layout."""
    in_ch, W = cfg.input_ch, cfg.netwidth
    if vch is None:
        vch = cfg.input_ch_views + cfg.input_ch_cam
    in_p, w_p, h_p = _rup(in_ch), _rup(W), _rup(W // 2)
    v_p = _rup(max(vch, 1))
    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    skip_mask = 0
    for i, layer in enumerate(model.pts_linears):
        w, b = _wb(layer)
        if (i - 1) in cfg.skips:
            skip_mask |= 1 << i
            ws += [_pad2(w[:in_ch], in_p, w_p), _pad2(w[in_ch:], w_p, w_p)]
        else:
            ws.append(_pad2(w, in_p if i == 0 else w_p, w_p))
        bs.append(_pad1(b, w_p))

    if cfg.use_viewdirs:
        wf, bf = _wb(model.feature_linear)
        wa, ba = _wb(model.alpha_linear)
        vw, vb = _wb(model.views_linears[0])
        wr, br = _wb(model.rgb_linear)
        if fold_heads:
            head = FOLDED
            wfv = wf @ vw[:W]                        # [W, W//2], fp32
            bfv = bf @ vw[:W] + vb
            wfa = wf.new_zeros(w_p, h_p + ALIGN)
            wfa[:W, :wfv.shape[1]] = wfv
            wfa[:W, h_p] = wa[:, 0]
            bfa = bf.new_zeros(h_p + ALIGN)
            bfa[:bfv.shape[0]] = bfv
            bfa[h_p] = ba[0]
            ws += [wfa, _pad2(vw[W:], v_p, h_p + ALIGN), _pad2(wr, h_p, ALIGN)]
            bs += [bfa, _pad1(br, ALIGN)]
        else:
            head = SPLIT
            waf = wf.new_zeros(w_p, w_p + ALIGN)
            waf[:W, :W] = wf
            waf[:W, w_p] = wa[:, 0]
            baf = bf.new_zeros(w_p + ALIGN)
            baf[:W] = bf
            baf[w_p] = ba[0]
            ws += [waf, _pad2(vw[:W], w_p, h_p), _pad2(vw[W:], v_p, h_p),
                   _pad2(wr, h_p, ALIGN)]
            bs += [baf, _pad1(vb, h_p), _pad1(br, ALIGN)]
    else:
        head = PLAIN
        if cfg.output_ch > ALIGN:
            raise ValueError(f"output_ch {cfg.output_ch} > {ALIGN}")
        wo, bo = _wb(model.output_linear)
        ws.append(_pad2(wo, w_p, ALIGN))
        bs.append(_pad1(bo, ALIGN))

    return PackedMLP(head=head, n_layers=len(model.pts_linears),
                     skip_mask=skip_mask, in_ch=in_ch, vch=vch, in_p=in_p,
                     w_p=w_p, v_p=v_p, h_p=h_p, dtype=dtype,
                     weights=[w.to(dtype).contiguous() for w in ws],
                     biases=[b.contiguous() for b in bs])


def _view_rows(v: Optional[torch.Tensor], n: int, v_div: int):
    if v is None or v_div == 1:
        return v
    return v[torch.arange(n, device=v.device) // v_div]


def forward_plain(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor],
                  v_div: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the same packed layout.

    x: [N, in_p] and v: [N / v_div, v_p] in the compute dtype.  Operands
    are taken in the compute dtype and summed in fp32, as the kernel does
    (on the card this needs TF32 off, which ``resolve_device`` ensures).
    Returns raw [N, 4] fp32.
    """
    dt = p.dtype

    def mm(a, w):
        return torch.matmul(a.to(dt).float(), w.float())

    wi, bi = iter(p.weights), iter(p.biases)
    h = x
    for i in range(p.n_layers):
        if (p.skip_mask >> i) & 1:
            z = mm(x, next(wi)) + mm(h, next(wi)) + next(bi)
        else:
            z = mm(h, next(wi)) + next(bi)
        h = F.relu(z)
    v = _view_rows(v, x.shape[0], v_div)
    if p.head == SPLIT:
        waf, wvf, wvv, wr = wi
        baf, bv, br = bi
        fa = mm(h, waf) + baf
        hv = F.relu(mm(fa[:, :p.w_p], wvf) + mm(v, wvv) + bv)
        rgb = mm(hv, wr) + br
        return torch.cat([rgb[:, :3], fa[:, p.w_p:p.w_p + 1]], dim=-1)
    if p.head == FOLDED:
        wfa, wvv, wr = wi
        bfa, br = bi
        t = mm(h, wfa) + mm(v, wvv) + bfa
        rgb = mm(F.relu(t[:, :p.h_p]), wr) + br
        return torch.cat([rgb[:, :3], t[:, p.h_p:p.h_p + 1]], dim=-1)
    (wo,), (bo,) = wi, bi
    return (mm(h, wo) + bo)[:, :4]


def fwd_chunks(n: int, v_div: int) -> List[Tuple[int, int]]:
    """(first point, points) of each launch sequence of the fp32 forward:
    at most ``FWD_CHUNK`` points, a whole number of view rows (``v_div``
    points each) unless one view row is longer, the last one ragged."""
    step = max(1, FWD_CHUNK // v_div) * v_div
    return [(r0, min(step, n - r0)) for r0 in range(0, n, step)]


def forward_chunked(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor],
                    v_div: int = 1) -> torch.Tensor:
    """The fp32 kernel's schedule in plain PyTorch: the per-layer product
    sequence of ``forward_plain`` on each of ``fwd_chunks``, each chunk
    reading its points' rows of x and its own view rows of v."""
    out = []
    for r0, cn in fwd_chunks(x.shape[0], v_div):
        vc = (None if v is None
              else v[r0 // v_div:-(-(r0 + cn) // v_div)])
        out.append(forward_plain(p, x[r0:r0 + cn], vc, v_div))
    return torch.cat(out) if out else forward_plain(p, x, v, v_div)


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.plnerf_fused_mlp_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        U = ctypes.c_uint
        fn.argtypes = [P, P, L, P, P, P, P, P, L, I, U, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.plnerf_fused_mlp_fwd_smem.argtypes = [I, I, I, I]
        lib.plnerf_fused_mlp_fwd_smem.restype = L
        lib.plnerf_fused_mlp_fwd_workspace.argtypes = [L, I, I]
        lib.plnerf_fused_mlp_fwd_workspace.restype = L
        lib.plnerf_cuda_error_string.argtypes = [I]
        lib.plnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, cols: int, dtype, device) -> None:
    if (t.device != device or t.dtype != dtype or t.dim() != 2
            or t.shape[1] != cols or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous {dtype} [*, {cols}] on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def forward_cuda(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor],
                 v_div: int = 1,
                 acts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream; raw [N, 4] fp32.
    bf16: one launch of the fused walk; fp32: the per-layer products of
    each of ``fwd_chunks`` in turn, on one workspace, or, given ``acts``
    [N, ``acts_cols``] fp32, keeping every activation there for
    ``backward_cuda``."""
    wbuf, bbuf = p.flat()
    return _launch(p, wbuf, bbuf, x, v, v_div, acts)


def acts_cols(p: PackedMLP) -> int:
    """Columns of the activations an fp32 training forward keeps for the
    backward (relu_0 .. relu_{L-1}, then split: feature, z_hv; folded:
    z_hv: csrc/acts_layout.cuh)."""
    return _bwd_library().plnerf_fused_mlp_bwd_acts_cols(
        p.n_layers, p.skip_mask, p.in_p, p.w_p, p.v_p, p.h_p, p.head)


def _launch(p: PackedMLP, wbuf: torch.Tensor, bbuf: torch.Tensor,
            x: torch.Tensor, v: Optional[torch.Tensor], v_div: int,
            acts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``forward_cuda`` on the buffers of ``PackedMLP.flat``; with
    ``acts`` (fp32, [N, ``acts_cols``]) the activations go there, for the
    backward, in place of the ping-pong workspace."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"forward_cuda needs CUDA tensors, got {dev}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {p.dtype}")
    _check(x, "x", p.in_p, p.dtype, dev)
    n = x.shape[0]
    if p.head != PLAIN:
        _check(v, "v", p.v_p, p.dtype, dev)
        if v_div < 1 or v.shape[0] * v_div < n:
            raise ValueError(f"v has {v.shape[0]} rows for {n} points at "
                             f"{v_div} per row")
    else:
        v, v_div = None, 1
    if wbuf.device != dev:
        raise ValueError(f"weights on {wbuf.device}, inputs on {dev}")
    raw = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if acts is not None:
        if p.dtype != torch.float32 or p.head == PLAIN:
            raise ValueError("only the fp32 viewdirs forward keeps its "
                             "activations")
        _check(acts, "acts", acts_cols(p), torch.float32, dev)
        if acts.shape[0] != n:
            raise ValueError(f"acts has {acts.shape[0]} rows for {n} points")
    if n == 0:
        return raw
    lib = _library()
    bf16 = int(p.dtype == torch.bfloat16)
    v_p = p.v_p if p.head != PLAIN else 0
    smem = lib.plnerf_fused_mlp_fwd_smem(p.in_p, p.w_p, v_p, bf16)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit or (bf16 and p.w_p > MAX_PASS):
        raise ValueError(f"fused MLP tile needs {smem} B of shared memory, "
                         f"the device allows {limit} B (netwidth too large)")
    chunks = [(0, n)] if bf16 else fwd_chunks(n, v_div)
    ws = torch.empty(0 if acts is not None else
                     lib.plnerf_fused_mlp_fwd_workspace(
                         chunks[0][1], p.w_p, bf16),
                     dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    esize = x.element_size()
    for r0, cn in chunks:
        rc = lib.plnerf_fused_mlp_fwd(
            x.data_ptr() + r0 * p.in_p * esize,
            None if v is None else v.data_ptr() + (r0 // v_div) * v_p * esize,
            v_div, wbuf.data_ptr(), bbuf.data_ptr(),
            raw.data_ptr() + r0 * 16, ws.data_ptr() if ws.numel() else None,
            None if acts is None else acts[r0].data_ptr(),
            cn, p.n_layers, p.skip_mask, p.in_p, p.w_p, v_p, p.h_p, p.head,
            bf16, stream)
        if rc != 0:
            msg = lib.plnerf_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_mlp_fwd launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return raw


def _layout(n_layers: int, skip_mask: int, in_p: int, w_p: int, v_p: int,
            h_p: int, head: int, bf16: bool) -> PackedMLP:
    """A ``PackedMLP`` with the op's layout integers and no blocks (the op
    does not know the unpadded widths: ``in_ch`` / ``vch`` hold the padded
    ones)."""
    return PackedMLP(head=head, n_layers=n_layers, skip_mask=skip_mask,
                     in_ch=in_p, vch=v_p, in_p=in_p, w_p=w_p, v_p=v_p,
                     h_p=h_p, dtype=torch.bfloat16 if bf16 else torch.float32,
                     weights=[], biases=[])


@torch.library.custom_op("plnerf_torch::fused_mlp_fwd", mutates_args=())
def fused_mlp_fwd(x: torch.Tensor, v: Optional[torch.Tensor],
                  wbuf: torch.Tensor, bbuf: torch.Tensor, v_div: int,
                  n_layers: int, skip_mask: int, in_p: int, w_p: int,
                  v_p: int, h_p: int, head: int, bf16: bool) -> torch.Tensor:
    """The fused forward as an operator that ``torch.export`` records by
    name (``torch.ops.plnerf_torch.fused_mlp_fwd``): raw [N, 4] fp32 of the
    packed MLP whose ``PackedMLP.flat`` buffers are ``wbuf`` / ``bbuf``.
    The dispatcher picks the implementation by the tensors' device: CUDA
    launches the kernel (``_launch``, or raises), the CPU runs
    ``forward_plain``; any other device is refused here."""
    raise ValueError(f"fused_mlp_fwd: unsupported device {x.device}")


@fused_mlp_fwd.register_kernel("cuda")
def _fused_mlp_fwd_cuda(x, v, wbuf, bbuf, v_div, *layout):
    return _launch(_layout(*layout), wbuf, bbuf, x, v, v_div)


@fused_mlp_fwd.register_kernel("cpu")
def _fused_mlp_fwd_cpu(x, v, wbuf, bbuf, v_div, *layout):
    p = _layout(*layout)
    return forward_plain(_unflat(p, wbuf, bbuf), x, v, v_div)


@fused_mlp_fwd.register_fake
def _fused_mlp_fwd_fake(x, v, wbuf, bbuf, v_div, *layout):
    return x.new_empty((x.shape[0], 4), dtype=torch.float32)


def forward_flat(p: PackedMLP, wbuf: torch.Tensor, bbuf: torch.Tensor,
                 x: torch.Tensor, v: Optional[torch.Tensor],
                 v_div: int = 1) -> torch.Tensor:
    """raw [N, 4] through the op, from weights already flattened by
    ``PackedMLP.flat`` (``p`` supplies only the layout)."""
    return torch.ops.plnerf_torch.fused_mlp_fwd(
        x, v, wbuf, bbuf, v_div, p.n_layers, p.skip_mask, p.in_p, p.w_p,
        p.v_p, p.h_p, p.head, p.dtype == torch.bfloat16)


def _flat_views(views_embed: torch.Tensor, lead: torch.Size
                ) -> Tuple[torch.Tensor, int]:
    """[R, 1, ch] per-ray views stay per ray (divisor S = lead[-1]);
    anything else is broadcast to every point (divisor 1)."""
    vch = views_embed.shape[-1]
    if len(lead) >= 1 and tuple(views_embed.shape[:-1]) == \
            tuple(lead[:-1]) + (1,):
        return views_embed.reshape(-1, vch), int(lead[-1])
    return views_embed.expand(tuple(lead) + (vch,)).reshape(-1, vch), 1


def prepare(model: NeRF, pts_embed: torch.Tensor,
            views_embed: Optional[torch.Tensor], cfg: ModelConfig,
            dtype=torch.float32, fold_heads: bool = False):
    """Pack the weights and pad the flattened inputs for the kernel:
    returns (packed, x [N, in_p], v [N / v_div, v_p] or None, v_div)."""
    x, v, v_div = _flatten(pts_embed, views_embed, cfg)
    p = pack_weights(model, cfg, dtype, fold_heads,
                     None if v is None else v.shape[-1])
    return (p,) + _pad(p, x, v, dtype) + (v_div,)


def _flatten(pts_embed: torch.Tensor, views_embed: Optional[torch.Tensor],
             cfg: ModelConfig):
    """(x [N, in_ch], v [N / v_div, vch] or None, v_div), unpadded."""
    x = pts_embed.reshape(-1, pts_embed.shape[-1])
    if not cfg.use_viewdirs:
        return x, None, 1
    if views_embed is None:
        raise ValueError("use_viewdirs model called without views")
    return (x,) + _flat_views(views_embed, pts_embed.shape[:-1])


def _pad(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor], dtype):
    """x and v padded to the layout's widths in the compute dtype."""
    if x.shape[-1] != p.in_ch:
        raise ValueError(f"pts_embed has {x.shape[-1]} channels, the model "
                         f"takes {p.in_ch}")
    x = F.pad(x, (0, p.in_p - p.in_ch)).to(dtype).contiguous()
    if v is not None:
        if v.shape[-1] != p.vch:
            raise ValueError(f"views_embed has {v.shape[-1]} channels, the "
                             f"packed model takes {p.vch}")
        v = F.pad(v, (0, p.v_p - p.vch)).to(dtype).contiguous()
    return x, v


class PackedNet(torch.nn.Module):
    """A ``NeRF`` packed once for the forward op, for forward-only use
    (the serving artifact): the two ``PackedMLP.flat`` buffers as module
    buffers and the layout without its blocks.  ``apply`` (and so
    ``core.mlp.query_network`` with ``use_fused``) takes it in place of
    the ``NeRF``, so a traced render holds the op and the buffers, never
    the packing."""

    def __init__(self, model: NeRF, cfg: ModelConfig, dtype=torch.float32,
                 fold_heads: bool = False):
        super().__init__()
        if (cfg.netdepth - 1) in cfg.skips:
            raise ValueError("a final-layer skip has no packed layout")
        p = pack_weights(model, cfg, dtype, fold_heads)
        wbuf, bbuf = p.flat()
        self.register_buffer("wbuf", wbuf)
        self.register_buffer("bbuf", bbuf)
        self.layout = dataclasses.replace(p, weights=[], biases=[])


def _layer_blocks(p: PackedMLP) -> Tuple[List[Tuple[Optional[int], int]], int]:
    """(x-block index or None, h-block index) of each pts layer in
    ``p.weights``, and the index of the first head block."""
    walk, k = [], 0
    for i in range(p.n_layers):
        if (p.skip_mask >> i) & 1:
            walk.append((k, k + 1))
            k += 2
        else:
            walk.append((None, k))
            k += 1
    return walk, k


def backward_plain(p: PackedMLP, x: torch.Tensor, v: torch.Tensor,
                   v_div: int, g: torch.Tensor, acc=torch.float32):
    """The backward kernel's function in plain PyTorch, on the packed
    layout (viewdirs topology).

    g: cotangent of raw [N, 4] (fp32).  Recomputes the forward, keeping
    each relu output in the compute dtype, and backpropagates as the kernel
    does: pre-relu grads are rounded to the compute dtype before they feed
    a product or a bias sum, products take compute-dtype operands and sum
    in ``acc`` (fp32, as the kernel; float64 gives a reference for the
    rounding of both).  Returns (dW, db, dx [N, in_p], dv [N, v_p]): grads
    of every packed weight block and bias, in ``p.weights`` / ``p.biases``
    order, and dv per point, in ``acc``.
    """
    if p.head == PLAIN:
        raise ValueError("the backward kernel takes the viewdirs topology")
    dt = p.dtype

    def c(a):
        return a.to(dt).to(acc)

    def mm(a, w):
        return torch.matmul(c(a), w.to(acc))

    def mm_nt(a, w):                       # a @ w^T
        return torch.matmul(c(a), w.to(acc).t())

    def mm_tn(a, d):                       # a^T @ d, summed over points
        return torch.matmul(c(a).t(), c(d))

    def relu_grad(z, dh):                  # jnp.where(z > 0, dh, 0)
        return c(torch.where(z > 0, dh, torch.zeros_like(dh)))

    W, B = p.weights, p.biases
    walk, hb = _layer_blocks(p)
    L = p.n_layers
    n = x.shape[0]
    dW: List[Optional[torch.Tensor]] = [None] * len(W)
    dB: List[Optional[torch.Tensor]] = [None] * len(B)

    acts, h = [], x
    for i, (bx, bh) in enumerate(walk):
        z = mm(h, W[bh]) + B[i]
        if bx is not None:
            z = mm(x, W[bx]) + z
        h = c(F.relu(z))
        acts.append(h)
    vr = _view_rows(v, n, v_div)
    d_rgb = c(F.pad(g[:, :3].float(), (0, ALIGN - 3)))
    d_alpha = c(F.pad(g[:, 3:4].float(), (0, ALIGN - 1)))
    if p.head == SPLIT:
        waf, wvf, wvv, wr = W[hb:hb + 4]
        baf, bv, _ = B[L:L + 3]
        feat = c(mm(h, waf)[:, :p.w_p] + baf[:p.w_p])
        zhv = c(F.relu(mm(feat, wvf) + mm(vr, wvv) + bv))
        dav = relu_grad(zhv, mm_nt(d_rgb, wr))
        dv = mm_nt(dav, wvv)
        dcat = torch.cat([c(mm_nt(dav, wvf)), d_alpha], 1)  # dfeat | d_alpha
        dW[hb:hb + 4] = [mm_tn(h, dcat), mm_tn(feat, dav), mm_tn(vr, dav),
                         mm_tn(zhv, d_rgb)]
        dB[L:L + 3] = [dcat.sum(0), dav.sum(0), d_rgb.sum(0)]
        dh = mm_nt(dcat, waf)
    else:
        wfa, wvv, wr = W[hb:hb + 3]
        t = mm(h, wfa) + mm(vr, wvv) + B[L]
        zhv = c(F.relu(t[:, :p.h_p]))
        dcat = torch.cat([relu_grad(zhv, mm_nt(d_rgb, wr)), d_alpha], 1)
        dv = mm_nt(dcat, wvv)                 # da_v | d_alpha
        dW[hb:hb + 3] = [mm_tn(h, dcat), mm_tn(vr, dcat), mm_tn(zhv, d_rgb)]
        dB[L:L + 2] = [dcat.sum(0), d_rgb.sum(0)]
        dh = mm_nt(dcat, wfa)

    dx = torch.zeros(n, p.in_p, dtype=acc, device=x.device)
    for i in range(L - 1, -1, -1):
        bx, bh = walk[i]
        da = relu_grad(acts[i], dh)
        dB[i] = da.sum(0)
        dW[bh] = mm_tn(x if i == 0 else acts[i - 1], da)
        if bx is not None:
            dW[bx] = mm_tn(x, da)
            dx = dx + mm_nt(da, W[bx])
        dh = mm_nt(da, W[bh])
    return dW, dB, dx + dh, dv


def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_KERNEL)
    fn = lib.plnerf_fused_mlp_bwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        U = ctypes.c_uint
        fn.argtypes = [P, P, L, P, P, P, L, P, P, P, P, P, P, L, I, U, I, I,
                       I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.plnerf_fused_mlp_bwd_smem.argtypes = [I, I, I, I, I]
        lib.plnerf_fused_mlp_bwd_smem.restype = L
        lib.plnerf_fused_mlp_bwd_stream_len.argtypes = [I, U, I, I, I, I, I]
        lib.plnerf_fused_mlp_bwd_stream_len.restype = L
        lib.plnerf_fused_mlp_bwd_workspace.argtypes = [L, I, U, I, I, I, I,
                                                       I, I]
        lib.plnerf_fused_mlp_bwd_workspace.restype = L
        lib.plnerf_fused_mlp_bwd_n_grad.argtypes = [I, U, I, I, I, I, I]
        lib.plnerf_fused_mlp_bwd_n_grad.restype = L
        lib.plnerf_fused_mlp_bwd_acts_cols.argtypes = [I, U, I, I, I, I, I]
        lib.plnerf_fused_mlp_bwd_acts_cols.restype = L
        lib.plnerf_cuda_error_string.argtypes = [I]
        lib.plnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def backward_cuda(p: PackedMLP, x: torch.Tensor, v: torch.Tensor,
                  v_div: int, g: torch.Tensor,
                  acts: Optional[torch.Tensor] = None):
    """Launch the backward kernel on the current stream; returns what
    ``backward_plain`` returns, the weight and bias grads as views of one
    fp32 buffer.  bf16 also gathers the data pass's weight stream
    (``bwd_stream``, one cached index).  ``acts`` (fp32 only): the
    activations ``forward_cuda`` kept for these inputs, which the data pass
    reads; without them an fp32 call runs that forward first.  bf16
    recomputes the forward on chip."""
    global bwd_launches, bwd_saved
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"backward_cuda needs CUDA tensors, got {dev}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {p.dtype}")
    if p.head == PLAIN:
        raise ValueError("the backward kernel takes the viewdirs topology")
    _check(x, "x", p.in_p, p.dtype, dev)
    _check(v, "v", p.v_p, p.dtype, dev)
    n = x.shape[0]
    _check(g, "g", 4, torch.float32, dev)
    if g.shape[0] != n:
        raise ValueError(f"g has {g.shape[0]} rows for {n} points")
    if v_div < 1 or v.shape[0] * v_div < n:
        raise ValueError(f"v has {v.shape[0]} rows for {n} points at "
                         f"{v_div} per row")
    if acts is not None:
        if p.dtype != torch.float32:
            raise ValueError("only the fp32 backward reads the forward's "
                             "activations")
        _check(acts, "acts", acts_cols(p), torch.float32, dev)
        if acts.shape[0] != n:
            raise ValueError(f"acts has {acts.shape[0]} rows for {n} points")
    given = acts is not None
    wbuf = torch.cat([w.reshape(-1) for w in p.weights])   # row-major
    bbuf = torch.cat([b.reshape(-1) for b in p.biases])
    if wbuf.device != dev:
        raise ValueError(f"weights on {wbuf.device}, inputs on {dev}")
    n_w = wbuf.numel()
    # the kernel writes every element (grads stay zeros for n = 0)
    grads = (torch.empty if n > 0 else torch.zeros)(
        n_w + bbuf.numel(), dtype=torch.float32, device=dev)
    dx = torch.empty((n, p.in_p), dtype=torch.float32, device=dev)
    dv = torch.empty((n, p.v_p), dtype=torch.float32, device=dev)
    if n > 0:
        lib = _bwd_library()
        bf16 = int(p.dtype == torch.bfloat16)
        if bf16 and max(p.w_p, p.in_p, p.v_p) > MAX_PASS:
            raise ValueError(f"bf16 backward takes layer widths up to "
                             f"{MAX_PASS} (netwidth too large)")
        layout = (p.n_layers, p.skip_mask, p.in_p, p.w_p, p.v_p, p.h_p,
                  p.head)
        if lib.plnerf_fused_mlp_bwd_n_grad(*layout) != grads.numel():
            raise ValueError("packed layout disagrees with the kernel's")
        smem = lib.plnerf_fused_mlp_bwd_smem(p.n_layers, p.in_p, p.w_p,
                                             p.v_p, bf16)
        limit = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        if smem > limit:
            raise ValueError(f"fused MLP backward tile needs {smem} B of "
                             f"shared memory, the device allows {limit} B")
        wstream = None
        if bf16:
            wstream = wbuf[_stream_index(p, dev, bwd_stream)]
            if wstream.numel() != lib.plnerf_fused_mlp_bwd_stream_len(
                    *layout):
                raise ValueError("backward weight stream disagrees with "
                                 "the kernel's walk")
        elif not given:     # the fp32 data pass reads the forward's acts
            acts = x.new_empty((n, acts_cols(p)))
            forward_cuda(p, x, v, v_div, acts)
        ws = torch.empty(lib.plnerf_fused_mlp_bwd_workspace(n, *layout, bf16),
                         dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.plnerf_fused_mlp_bwd(
            x.data_ptr(), v.data_ptr(), v_div, g.data_ptr(), wbuf.data_ptr(),
            None if wstream is None else wstream.data_ptr(),
            0 if wstream is None else wstream.numel(), bbuf.data_ptr(),
            None if acts is None else acts.data_ptr(), grads.data_ptr(),
            dx.data_ptr(), dv.data_ptr(), ws.data_ptr(), n, *layout, bf16,
            stream)
        if rc != 0:
            msg = lib.plnerf_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_mlp_bwd launch failed: {msg} ({rc})")
        if not torch.cuda.is_current_stream_capturing():
            bwd_launches += 1
            bwd_saved += given
    dW, dB, off = [], [], 0
    for w in p.weights:
        dW.append(grads[off:off + w.numel()].view(w.shape))
        off += w.numel()
    for b in p.biases:
        dB.append(grads[off:off + b.numel()])
        off += b.numel()
    return dW, dB, dx, dv


def unpack_grads(p: PackedMLP, model: NeRF, dW, dB):
    """Packed grads (viewdirs topology) -> {parameter name: grad} in each
    ``nn.Linear``'s [out, in] layout: split layers re-concatenated, padding
    cut, and the folded head's grads unfolded by the chain rule of
    ``Wfv = Wf @ Wv1f``, ``bv' = bf @ Wv1f + bv``:
    dWf = dWfv Wv1f^T, dbf = dbv' Wv1f^T, dWv1f = Wf^T dWfv + bf (x) dbv',
    dbv = dbv' (the JAX package's ``_backward`` unfold)."""
    W, in_ch = p.w_p, p.in_ch
    out = {}
    wi, bi = iter(dW), iter(dB)
    for i, layer in enumerate(model.pts_linears):
        width = layer.out_features
        if (p.skip_mask >> i) & 1:
            w = torch.cat([next(wi)[:in_ch, :width], next(wi)[:width, :width]])
        else:
            w = next(wi)[:layer.in_features, :width]
        out[f"pts_linears.{i}.weight"] = w.t()
        out[f"pts_linears.{i}.bias"] = next(bi)[:width]
    width = model.feature_linear.out_features
    H = model.rgb_linear.in_features
    vch = model.views_linears[0].in_features - width
    if p.head == SPLIT:
        dwaf, dwvf, dwvv, dwr = wi
        dbaf, dbv, dbr = bi
        out["feature_linear.weight"] = dwaf[:width, :width].t()
        out["feature_linear.bias"] = dbaf[:width]
        out["alpha_linear.weight"] = dwaf[:width, W:W + 1].t()
        out["alpha_linear.bias"] = dbaf[W:W + 1]
        dwv1 = dwvf[:width, :H]
    else:
        dwfa, dwvv, dwr = wi
        dbfa, dbr = bi
        dwfv, dbv = dwfa[:width, :H], dbfa[:H]
        wf, bf = _wb(model.feature_linear)
        wv1 = _wb(model.views_linears[0])[0][:width]
        out["feature_linear.weight"] = (dwfv @ wv1.t()).t()
        out["feature_linear.bias"] = dbv @ wv1.t()
        out["alpha_linear.weight"] = dwfa[:width, p.h_p:p.h_p + 1].t()
        out["alpha_linear.bias"] = dbfa[p.h_p:p.h_p + 1]
        dwv1 = wf.t() @ dwfv + torch.outer(bf, dbv)
    out["views_linears.0.weight"] = torch.cat([dwv1, dwvv[:vch, :H]]).t()
    out["views_linears.0.bias"] = dbv[:H]
    out["rgb_linear.weight"] = dwr[:H, :3].t()
    out["rgb_linear.bias"] = dbr[:3]
    return out


def forward(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor],
            v_div: int = 1) -> torch.Tensor:
    """raw [N, 4] of the packed MLP through the op ``fused_mlp_fwd``: a
    CPU tensor runs ``forward_plain``, a CUDA tensor the kernel."""
    wbuf, bbuf = p.flat()
    return forward_flat(p, wbuf, bbuf, x, v, v_div)


class FusedMLPFunction(torch.autograd.Function):
    """raw [N, 4] of the packed MLP with a fused backward (the JAX
    ``_apply_flat`` custom VJP).  ``pts``, ``views`` and ``params`` are the
    differentiable inputs that ``x``/``v`` and the packed weights were made
    from; the forward reads only the packed tensors, which ``ctx`` keeps so
    nothing is packed twice.

    On the card, the fp32 viewdirs forward writes its activations to a
    buffer [N, ``acts_cols``] that ``ctx`` keeps (in place of its ping-pong
    workspace), and the backward's data pass reads them, so the forward
    runs once: 8.7 KB a point (folded 8x256) held from the forward to the
    backward.  bf16 recomputes the forward on chip in its backward;
    ``torch.utils.checkpoint`` (``--remat``) reruns this forward in the
    backward and drops what it kept."""

    @staticmethod
    def forward(ctx, p, x, v, v_div, model, cfg, pts, views, *params):
        ctx.p, ctx.v_div, ctx.model, ctx.cfg = p, v_div, model, cfg
        if x.is_cuda and p.dtype == torch.float32 and p.head != PLAIN:
            acts = x.new_empty((x.shape[0], acts_cols(p)))
            raw = forward_cuda(p, x, v, v_div, acts)
        else:
            acts, raw = None, forward(p, x, v, v_div)
        ctx.save_for_backward(x, v, pts, views, acts)
        return raw

    @staticmethod
    def backward(ctx, g):
        p, v_div, model = ctx.p, ctx.v_div, ctx.model
        x, v, pts, views, acts = ctx.saved_tensors
        names = [name for name, _ in model.named_parameters()]
        if p.head == PLAIN:
            # the JAX wrapper's XLA vjp for this topology: autograd through
            # the unfused MLP, raw density out
            cfg = dataclasses.replace(ctx.cfg, density_activation="none")
            with torch.enable_grad():
                pe = pts.detach().requires_grad_()
                raw = apply_mlp(model, pe, None, cfg, p.dtype)
                grads = torch.autograd.grad(
                    raw, [pe] + list(model.parameters()), g)
            return (None,) * 6 + (grads[0], None) + tuple(grads[1:])
        g = g.float().contiguous()
        if g.device.type == "cuda":
            dW, dB, dx, dv = backward_cuda(p, x, v, v_div, g, acts)
        else:
            dW, dB, dx, dv = backward_plain(p, x, v, v_div, g)
        named = unpack_grads(p, model, dW, dB)
        dviews = dv[:, :views.shape[-1]]
        if v_div > 1:                       # fixed-order sum over samples
            dviews = dviews.reshape(-1, v_div, dviews.shape[-1]).sum(1)
        return ((None,) * 6 + (dx[:, :p.in_ch].to(pts.dtype),
                               dviews.to(views.dtype))
                + tuple(named[name] for name in names))


def apply(model: NeRF, pts_embed: torch.Tensor,
          views_embed: Optional[torch.Tensor], cfg: ModelConfig,
          dtype=torch.float32, fold_heads: bool = False) -> torch.Tensor:
    """Drop-in for ``core.mlp.apply_mlp`` on embedded inputs of any
    leading shape: raw [..., 4].  CPU tensors run ``forward_plain`` (and
    ``backward_plain``), CUDA tensors ``forward_cuda`` (and
    ``backward_cuda``).  A ``PackedNet`` runs the forward op on its
    buffers, without gradients."""
    lead = pts_embed.shape[:-1]
    if isinstance(model, PackedNet):
        p = model.layout
        if p.dtype != dtype:
            raise ValueError(f"model packed in {p.dtype}, called in {dtype}")
        x, v, v_div = _flatten(pts_embed, views_embed, cfg)
        x, v = _pad(p, x, v, dtype)
        raw = forward_flat(p, model.wbuf, model.bbuf, x, v, v_div)
        return softplus10_density(raw, cfg).reshape(tuple(lead) + (4,))
    if (cfg.netdepth - 1) in cfg.skips:
        # a final-layer skip would feed the heads a two-block input; no
        # shipped topology does this
        return apply_mlp(model, pts_embed, views_embed, cfg, dtype)
    p, x, v, v_div = prepare(model, pts_embed, views_embed, cfg, dtype,
                             fold_heads)
    params = list(model.parameters())
    if torch.is_grad_enabled() and (
            pts_embed.requires_grad or any(q.requires_grad for q in params)
            or (views_embed is not None and views_embed.requires_grad)):
        pts = pts_embed.reshape(-1, pts_embed.shape[-1])
        views = (_flat_views(views_embed, lead)[0] if cfg.use_viewdirs
                 else pts.new_zeros(0))
        raw = FusedMLPFunction.apply(p, x, v, v_div, model, cfg, pts, views,
                                     *params)
    else:
        raw = forward(p, x, v, v_div)
    return softplus10_density(raw, cfg).reshape(tuple(lead) + (4,))
