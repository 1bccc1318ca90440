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
with the alpha column; its view block spans the same N.  The bf16 kernel
(tensor cores, ``mma.sync``) reads each block in mma fragment order
(``mma_fragments``, applied by ``PackedMLP.flat``); the plain version
reads the same blocks as ``[K, N]`` matrices.

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
KERNEL = "fused_mlp_fwd"
BWD_KERNEL = "fused_mlp_bwd"

# CUDA launches made by ``forward_cuda`` and ``backward_cuda`` (chip_smoke.py
# resets and reads them to show that a render or a train step went through
# the kernels)
launches = 0
bwd_launches = 0


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
        """The kernel's weight buffer (fp32 blocks row-major, bf16 blocks in
        mma fragment order) and its bias buffer."""
        order = mma_fragments if self.dtype == torch.bfloat16 else \
            (lambda w: w.reshape(-1))
        return (torch.cat([order(w) for w in self.weights]),
                torch.cat([b.reshape(-1) for b in self.biases]))

    def flat_t(self) -> torch.Tensor:
        """The backward kernel's transposed weights: every block as [N, K]
        at the offset of its [K, N] block in ``flat()`` (bf16 in mma
        fragment order)."""
        order = mma_fragments if self.dtype == torch.bfloat16 else \
            (lambda w: w.reshape(-1))
        return torch.cat([order(w.t().contiguous()) for w in self.weights])


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """A [K, N] block in mma.sync m16n8k16 B-fragment order: per 16-row k
    block and 8-column n block (n innermost), lane 4g + t holds
    W[k0][n], W[k0+1][n], W[k0+8][n], W[k0+9][n], k0 = 16kb + 2t,
    n = 8nb + g.  K and N are multiples of 32 here."""
    K, N = w.shape
    # k = 16 kb + 8 h + 2 t + e, n = 8 nb + g  ->  order (kb, nb, g, t, h, e)
    return w.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(
        0, 4, 5, 2, 1, 3).reshape(-1)


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


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.plnerf_fused_mlp_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, L, P, P, P, L, I, ctypes.c_uint, I, I, I, I, I,
                       I, P]
        fn.restype = ctypes.c_int
        lib.plnerf_fused_mlp_fwd_smem.argtypes = [I, I, I, I]
        lib.plnerf_fused_mlp_fwd_smem.restype = L
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
                 v_div: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raw [N, 4] fp32."""
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
    wbuf, bbuf = p.flat()
    if wbuf.device != dev:
        raise ValueError(f"weights on {wbuf.device}, inputs on {dev}")
    raw = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return raw
    lib = _library()
    bf16 = int(p.dtype == torch.bfloat16)
    v_p = p.v_p if p.head != PLAIN else ALIGN
    smem = lib.plnerf_fused_mlp_fwd_smem(p.in_p, p.w_p, v_p, bf16)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"fused MLP tile needs {smem} B of shared memory, "
                         f"the device allows {limit} B (netwidth too large)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.plnerf_fused_mlp_fwd(
        x.data_ptr(), v.data_ptr() if p.head != PLAIN else None, v_div,
        wbuf.data_ptr(), bbuf.data_ptr(), raw.data_ptr(), n, p.n_layers,
        p.skip_mask, p.in_p, p.w_p, v_p, p.h_p, p.head, bf16, stream)
    if rc != 0:
        msg = lib.plnerf_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_mlp_fwd launch failed: {msg} ({rc})")
    launches += 1
    return raw


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
    lead = pts_embed.shape[:-1]
    x = pts_embed.reshape(-1, pts_embed.shape[-1])
    v, v_div = None, 1
    vch = None
    if cfg.use_viewdirs:
        if views_embed is None:
            raise ValueError("use_viewdirs model called without views")
        v, v_div = _flat_views(views_embed, lead)
        vch = v.shape[-1]
    p = pack_weights(model, cfg, dtype, fold_heads, vch)
    if x.shape[-1] != p.in_ch:
        raise ValueError(f"pts_embed has {x.shape[-1]} channels, the model "
                         f"takes {p.in_ch}")
    x = F.pad(x, (0, p.in_p - p.in_ch)).to(dtype).contiguous()
    if v is not None:
        v = F.pad(v, (0, p.v_p - vch)).to(dtype).contiguous()
    return p, x, v, v_div


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
        fn.argtypes = [P, P, L, P, P, P, P, P, P, P, P, L, I, U, I, I, I, I,
                       I, I, P]
        fn.restype = ctypes.c_int
        lib.plnerf_fused_mlp_bwd_smem.argtypes = [I, I, I, I]
        lib.plnerf_fused_mlp_bwd_smem.restype = L
        lib.plnerf_fused_mlp_bwd_workspace.argtypes = [L, I, U, I, I, I, I,
                                                       I, I]
        lib.plnerf_fused_mlp_bwd_workspace.restype = L
        lib.plnerf_fused_mlp_bwd_n_grad.argtypes = [I, U, I, I, I, I, I]
        lib.plnerf_fused_mlp_bwd_n_grad.restype = L
        lib.plnerf_cuda_error_string.argtypes = [I]
        lib.plnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def backward_cuda(p: PackedMLP, x: torch.Tensor, v: torch.Tensor,
                  v_div: int, g: torch.Tensor):
    """Launch the backward kernel on the current stream; returns what
    ``backward_plain`` returns, the weight and bias grads as views of one
    fp32 buffer."""
    global bwd_launches
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
    wbuf, bbuf = p.flat()
    if wbuf.device != dev:
        raise ValueError(f"weights on {wbuf.device}, inputs on {dev}")
    wtbuf = p.flat_t()
    n_w = wbuf.numel()
    grads = torch.zeros(n_w + bbuf.numel(), dtype=torch.float32, device=dev)
    dx = torch.zeros((n, p.in_p), dtype=torch.float32, device=dev)
    dv = torch.zeros((n, p.v_p), dtype=torch.float32, device=dev)
    if n > 0:
        lib = _bwd_library()
        bf16 = int(p.dtype == torch.bfloat16)
        layout = (p.n_layers, p.skip_mask, p.in_p, p.w_p, p.v_p, p.h_p,
                  p.head)
        if lib.plnerf_fused_mlp_bwd_n_grad(*layout) != grads.numel():
            raise ValueError("packed layout disagrees with the kernel's")
        smem = lib.plnerf_fused_mlp_bwd_smem(p.in_p, p.w_p, p.v_p, bf16)
        limit = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        if smem > limit:
            raise ValueError(f"fused MLP backward tile needs {smem} B of "
                             f"shared memory, the device allows {limit} B")
        ws = torch.empty(lib.plnerf_fused_mlp_bwd_workspace(n, *layout, bf16),
                         dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.plnerf_fused_mlp_bwd(
            x.data_ptr(), v.data_ptr(), v_div, g.data_ptr(), wbuf.data_ptr(),
            wtbuf.data_ptr(), bbuf.data_ptr(), grads.data_ptr(),
            dx.data_ptr(), dv.data_ptr(), ws.data_ptr(), n, *layout, bf16,
            stream)
        if rc != 0:
            msg = lib.plnerf_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_mlp_bwd launch failed: {msg} ({rc})")
        bwd_launches += 1
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


def _forward(p: PackedMLP, x: torch.Tensor, v: Optional[torch.Tensor],
             v_div: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return forward_plain(p, x, v, v_div)
    if x.device.type == "cuda":
        return forward_cuda(p, x, v, v_div)
    raise ValueError(f"unsupported device {x.device}")


class FusedMLPFunction(torch.autograd.Function):
    """raw [N, 4] of the packed MLP with a fused backward (the JAX
    ``_apply_flat`` custom VJP).  ``pts``, ``views`` and ``params`` are the
    differentiable inputs that ``x``/``v`` and the packed weights were made
    from; the forward reads only the packed tensors, which ``ctx`` keeps so
    nothing is packed twice."""

    @staticmethod
    def forward(ctx, p, x, v, v_div, model, cfg, pts, views, *params):
        ctx.p, ctx.v_div, ctx.model, ctx.cfg = p, v_div, model, cfg
        ctx.save_for_backward(x, v, pts, views)
        return _forward(p, x, v, v_div)

    @staticmethod
    def backward(ctx, g):
        p, v_div, model = ctx.p, ctx.v_div, ctx.model
        x, v, pts, views = ctx.saved_tensors
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
        bwd = backward_cuda if g.device.type == "cuda" else backward_plain
        dW, dB, dx, dv = bwd(p, x, v, v_div, g)
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
    ``backward_cuda``)."""
    if (cfg.netdepth - 1) in cfg.skips:
        # a final-layer skip would feed the heads a two-block input; no
        # shipped topology does this
        return apply_mlp(model, pts_embed, views_embed, cfg, dtype)
    lead = pts_embed.shape[:-1]
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
        raw = _forward(p, x, v, v_div)
    return softplus10_density(raw, cfg).reshape(tuple(lead) + (4,))
