"""Static configuration objects for the renderer and model.

Own copy of ``plnerf/core/config.py`` (``ModelConfig``/``RenderConfig``),
with the kernel switches renamed for the port: ``use_pallas_mlp`` is
``use_fused_mlp`` and ``pallas_fold_heads`` is ``fused_fold_heads``.  No
other field changes meaning.  Frozen dataclasses, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """NeRF MLP + positional-encoding configuration (see the JAX
    package's ``ModelConfig`` for each field's reference)."""
    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    multires: int = 10          # position encoding frequencies
    multires_views: int = 4     # view-direction encoding frequencies
    i_embed: int = 0            # 0 = positional encoding, -1 = identity
    pi_bands: bool = False      # depth-exps variant: multiply x by pi*freq
    input_ch_cam: int = 0       # camera-embedding channels (depth exps)
    # 'none': raw density out; 'softplus10': softplus(beta=10) on density
    density_activation: str = "none"
    output_ch: int = 4          # only used when use_viewdirs=False
    # 'torch_linear' = U(-1/sqrt(fan_in), +1/sqrt(fan_in)) weight and bias;
    # 'xavier' = xavier_uniform with relu/linear gain and zero bias
    init: str = "torch_linear"
    # constant added to the density head's bias at init time
    sigma_bias_init: float = 0.0

    @property
    def input_ch(self) -> int:
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires

    @property
    def input_ch_views(self) -> int:
        if not self.use_viewdirs:
            return 0
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires_views


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration for ``render_rays``."""
    n_samples: int = 64
    n_importance: int = 128
    mode: str = "linear"              # 'linear' | 'constant'
    color_mode: str = "midpoint"      # 'midpoint' | 'left' | 'tau_weighted'
    lindisp: bool = False
    perturb: bool = True              # stratified jitter of coarse samples
    use_viewdirs: bool = True
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    zero_tol: float = 1e-4
    epsilon: float = 1e-3
    farcolorfix: bool = False
    constant_init: bool = False       # force constant mode (warmup)
    # depth-supervision extras (compute_pred_hyp is not ported yet)
    compute_pred_hyp: bool = False
    is_joint: bool = False
    trim_first_weight: bool = True
    retraw: bool = False
    # compute dtype for the MLP matmuls: 'float32' or 'bfloat16'
    mlp_dtype: str = "float32"
    # run the MLP through the fused CUDA kernel (kernels/fused_mlp.py)
    use_fused_mlp: bool = False
    # fused head schedule: fold the relu-free feature dot into the views
    # layer and N-merge it with the alpha head (same math, fewer FLOPs)
    fused_fold_heads: bool = False
    # occupancy-grid guided coarse sampling; not ported yet (must be None)
    occ: Optional[Any] = None
    # training: recompute the MLP query in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations
    remat_mlp: bool = False

    @property
    def effective_mode(self) -> str:
        # reference run_plnerf.py:709-711: constant_init overwrites mode
        return "constant" if self.constant_init else self.mode
