"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, one line each, then the result line:

1. env     card name and power limit (nvidia-smi), torch / CUDA versions,
           and the build of every kernel under plnerf_torch/kernels/csrc
           (one nvcc per source, all started together).
2. kernel  the fused MLP forward kernel against its plain PyTorch version
           on the card: 8x256 viewdirs MLP (input 63, views 27) at 65,537
           points, split / folded / plain heads, and at the coarse and fine
           passes of a 32,768-ray chunk, in fp32 (tolerance 1e-4) and bf16
           (2e-2); then kernel, plain-version and unfused
           ``apply_mlp`` (cuBLAS) times at one fine pass of a 32,768-ray
           chunk (6.29 M points), beside the bound, and the device time of
           each fp32 launch (one per product and chunk) from a short
           torch.profiler window.
3. probes  the four dot-probe kernels of plnerf_torch/kernels/csrc/dot_probe.cu
           (shape, mixed, merged with a scratch or a concatenated operand,
           mosaic chained / independent / mlp) against their plain PyTorch
           versions at 2,629,632 rows, every shape, variant and row tile
           (tolerance 1e-5 x max|ref| without a bf16 recast between dots,
           2e-2 x max|ref| with one); then the probe path: every experiment of
           plnerf_torch.tools.dot_decompose (A shapes, B mixed, D row tile,
           E merged, C the real bf16 forward), plnerf_torch.tools.
           mosaic_probe and shape (256, 256) x13 at every row tile it takes
           at 2,629,632 rows, with the kernels' launch counters set to 0
           before and read after; the decomposition (A's predicted walk
           beside B and C, all three on one wgmma product code); and
           each kernel's plain-version and cuBLAS times beside the bound
           (cuBLAS bf16 sums in fp32: resolve_device turns its
           reduced-precision reductions off).
4. bwd     the fused MLP backward kernel against its plain PyTorch version
           on the card: 8x256 viewdirs MLP at 65,537 points (one ray, a
           ragged last tile) and at the coarse (1024 x 128) and fine
           (1024 x 192) passes of a 1024-ray train step, split and folded
           heads, fp32 (relative L2 tolerance 1e-3, beside the plain
           version's own distance from a float64 evaluation) and bf16
           (2e-2), per-ray views, every call made twice and held to
           bit-identical results; then kernel, plain-version and
           autograd-through-``apply_mlp`` (cuBLAS) times at the fine pass,
           beside the bound, the share of it and the byte floor of the
           workspace's traffic, each pass's device time (data, weight,
           reduce) from a short torch.profiler window, and the data and
           weight kernels' registers and spills.
5. slice   ``ServingRenderer.from_params`` at full width (two 8x256 MLPs,
           128 + 64 samples, linear, white background, fused MLP on) with
           seeded random weights: three 32,768-ray requests (test config,
           perturb kept, seeds 0-2), the first again with bf16 MLPs, and
           one 400x400 image (800x800 Blender intrinsics, render_factor 2)
           in eval_det mode, rendered twice.
           The kernels' launch counters are set to 0 before and read after.
6. ref     the card's render of 512 rays against the CPU render (the
           kernel's plain version) of the same weights.
6a. export the serving artifact (``plnerf_torch.serving.export``) of the
           slice phase's weights and render configs (perturb kept), fp32
           and bf16, ``baked`` and ``args`` weights, each with a
           whole-batch module for one 400x400 image: export and load
           times, then ``ServingRenderer.load``'s three 32,768-ray
           requests (seeds 0-2) and one 400x400 image, through the
           whole-batch module and through the chunk module, held against
           ``from_params`` on the same requests (``EXPORT_TOL``; equality
           expected) and timed beside it.  The forward launch counter is
           set to 0 before the artifacts' calls and read after; each path
           must launch the kernel exactly as often as ``from_params``.
7. train   the NVS training step of configs/blender_linear.txt at full
           width (two 8x256 MLPs, 128 + 64 samples, 1024 rays per step
           from one image, two Adams under the exponential decay, fused
           MLP on with folded heads) on the numpy sphere scene, 8 views at
           200x200, seeded random weights: 30 steps of each variant the
           JAX driver switches between (precrop + constant quadrature,
           constant quadrature, linear; its 500 / 1000-step boundaries cut
           to 30 / 60), then 20 bf16 steps.  The kernels' launch counters
           are set to 0 before and read after; every step must launch each
           kernel twice (coarse, fine) and the loss must fall.  Then three
           more fp32 steps and three bf16 steps under torch.profiler:
           device time by kernel and the backward's share of it (bf16:
           the data and weight passes beside PR 11's 6.57 / 1.62 ms).
7a. interop the train phase's final state written as a reference ``.tar``
           (``checkpoint.convert_torch.save_reference_checkpoint``, the
           fine Adam's moments in the reference's parameter order), read
           back on the card by ``load_reference_checkpoint`` and by
           ``checkpoint.io.restore_checkpoint`` into a fresh state (same
           networks and moments); both render the same 512 rays (eval_det)
           bit-equal to the state they came from.
8. train_reference  three steps from the same weights on the same injected
           batch (256 rays, perturb off) on the card (kernels) and on the
           CPU (plain versions), and the card's first step with the
           unfused MLP: step-1 grads and per-step losses.
9. driver  the port's PL-NeRF driver, ``plnerf_torch.cli.run_plnerf.main``
           with ``--config configs/blender_linear.txt`` at full width, on a
           Blender-layout scene it writes first with the port's own code
           (``transforms_{train,val,test}.json`` and RGBA pngs of the numpy
           sphere, 8 / 1 / 2 views at 400x400, the lego camera_angle_x):
           train 300 steps (precrop and constant-quadrature boundaries cut
           to 50 / 100, checkpoints and val renders every 150), resume to
           400 with ``--profile 5`` (steps 304-308 traced: the trace file
           and its top device kernels), test from the step-400 checkpoint
           with ``--lpips_weights`` (seeded random weights the phase
           writes: a finite lpips row, the card's LPIPS of the two test
           images held against the CPU's on the same arrays at 1e-5
           relative, s per image at 400x400 and 800x800) and test the
           fresh init (``--no_reload``), then ``--task test_fixed_dist``
           (with the LPIPS weights) from the
           step-400 checkpoint on a blender_fixeddist layout of the sphere
           it writes (``transforms_radius{d}_test.json``, one 400x400 view
           at each distance of ``FIXED_DIST_NEAR``).  The kernels' launch
           counters are set to 0 before each run and read after: every
           train step launches the forward and the backward kernel twice
           each, eval adds forward launches only (two per chunk).  Checks
           the checkpoints, the resume, a falling loss, metrics.txt, a
           held-out PSNR above the fresh init's and the four fixed-dist
           result folders; logs ms per step (from metrics.jsonl), s per
           test image, checkpoint save / load s, PSNR / SSIM, and PSNR and
           s per image at each distance.
10. llff   the driver on ``configs/llff_linear.txt`` at full width (two
           8x256 MLPs, 128 + 64 samples, ``raw_noise_std`` 1, NDC rays,
           the shuffled pool of every training ray), on an LLFF-layout
           scene written with the port's ``make_llff_fixture`` at the
           geometry ``factor = 8`` reads from a published scene: 20 views
           (fern's count), ``images_8/`` PNGs at 378x504 and a
           ``poses_bounds.npy`` whose hwf is the full 3024 x 4032, so the
           loader's factor path runs with no minify.  Train 300 steps
           (constant quadrature cut to 100, ``i_print`` 50, val render and
           checkpoint at 150 and 300) on the 17 training views, test the 3
           held-out views (llffhold 8: views 0, 8, 16) and the fresh init,
           then ``--task test_samples_error --eval_det``.  Launches counted
           as in the driver phase.  Checks a falling loss, a held-out PSNR
           above the fresh init's, the pool (12 columns, 17 x 378 x 504
           rows), a finite ``metrics_expecteddepth.txt``, and one held-out
           view with ``--eval_det`` rendered whole on the card against every
           8th pixel on the CPU (``REFERENCE_TOL``, and ``pred_hyp`` at the
           depth tolerance 1e-2); logs ms per step, pool build s, s per
           test image, PSNR / SSIM and the importance-sampling error.
11. jpeg   the port's JPEG decoder (``plnerf_torch/data/jpeg.py``, its
           entropy stage built with g++ here) on the committed fixtures of
           ``tests/data/torch_jpeg/``: every conformance file (sampling
           4:4:4 to 4:1:1 and gray, progressive, restart intervals,
           optimised tables, q10-q100, 1x1 to 61x83, EXIF-tagged) against
           its manifest digest (cv2's decode), all equal or the phase
           raises; the 4032x3024 q90 file decoded ``JPEG_DECODES`` times
           (median s per image, MP/s, the entropy / IDCT / upsample /
           colour stages); then the LLFF recipe from the 20-view capture
           (``images/*.jpg`` at 1008x756, baseline and progressive) copied
           to a temporary directory: ``--config configs/llff_linear.txt
           --factor 2 --dataset llff`` at full width, ``JPEG_STEPS`` steps
           and a resume to ``JPEG_RESUME_STEPS``, then ``--task test``.
           Checks ``images_2/`` written at 378x504 (fern's factor-8
           training size) equal to its manifest digests, both kernels'
           launches, a falling loss and a finite held-out PSNR; logs the
           card line, the host CPU, the build, decode and minify seconds
           and ms per step.
12. depth  both kernels at the depth topology (input 57 padded to 64, views
           3 + a 4-channel camera embedding padded to 32, per ray; folded
           heads) against their plain versions, fp32 and bf16 (forward
           1e-4 / 2e-2 x max(1, max|raw|); backward 1e-3 / 2e-2 relative L2
           per block, dv included); then the depth driver,
           ``plnerf_torch.cli.run_depth.main``, on the multi-object scene
           it writes with ``write_blender2_depth_scene`` (blender2_depth
           layout, 10 / 1 / 9 views at 200x200 of which the loader reads 2
           test views): the depth recipe at full width (linear, 128 + 64
           samples, 1024 rays, space carving 0.007 from step 50, scale /
           shift frozen from 150, 4 camera channels trained), 300 steps
           and a resume to 350, ``--task test --eval_det`` at 350 (with
           ``--lpips_weights``: a finite lpips row) and on
           the fresh init (3 epochs of camera optimization per view, the
           driver's 100 cut), ``test_samples_error --eval_det``,
           ``optimize_camera_embedding`` called on one test view, and step
           1 on the card against the CPU (losses 1e-3 relative; grads of
           both networks 1e-3 relative L2, scales, shifts and embeddings
           1e-3).  Then two seeded runs of 70 steps (20 past the warm
           start) that must repeat bit for bit (logged losses, every
           tensor of the final state), and a 60-step run with
           ``--occ_grid`` (warm-up 20; its line is the occ phase's).
           Launches counted as in the driver phase.  Checks a
           falling loss and space-carving loss, scale / shift means that
           move and then hold, a held-out depth RMSE below the fresh
           init's, the metric files; logs ms per step, s per test image,
           PSNR / SSIM / depth RMSE.
13. occ    the driver on ``configs/blender_linear_occ.txt`` at full width
           (two 8x256 MLPs, bf16, 32 grid-guided + 64 importance samples,
           a 128^3 grid with 96 candidate bins over [-1.5, 1.5]^3) on the
           driver phase's sphere: 300 steps (warm-up cut from 500 to 100,
           precrop and constant quadrature as the driver phase cuts them,
           ``i_print`` 10, checkpoints every 300, val renders every 600),
           a resume to 1200 from the ``.occ`` sidecar (the grid guides at
           once; on this scene it starts to carve near step 1000),
           ``--task test``; and ``configs/blender_linear.txt --mlp_dtype
           bfloat16`` for the same 1200 steps and test.  Both bf16
           kernels held against their plain
           versions on the calls of one guided step and one 32,768-ray
           eval chunk with the grid (2e-2 as in the depth phase); the grid
           functions on the card against the CPU on the same inputs
           (exact; ``occ_guided_z_vals`` 1e-5) and one fp32 guided step
           (losses 1e-3 relative, grads 1e-3 relative L2, the updated
           grid's ``occ`` differing in at most ``OCC_FLIP_BOUND`` of the
           voxels); two seeded runs of the first guided steps bit-equal in
           losses, state and grid.  Launches counted as in the driver
           phase.  Checks that the grid guides every step past the
           warm-up, that ``occ_ray_frac`` falls from the first guided print
           to the end, that the centre voxel stays occupied; logs both
           arms' ms per step (the occ arm's warm-up and guided windows
           apart), s per test image, PSNR / SSIM, ``occ_ray_frac`` and the
           grid's occupied share.

14. video  the camera-path videos on the driver phase's step-400
           checkpoint: ``run_plnerf.main --task video --render_factor 4``
           (the 40 hemisphere poses at 100x100), ``--render_only
           --render_test`` (the 2 test views at 400x400), a 20-step
           continuation of a copy of the run with ``--i_video 10`` (one
           video, at step 410), and ``run_depth.main video`` on the depth
           phase's step-350 checkpoint (the 40 poses of its video split at
           200x200, rgb, 16-bit depth and Turbo frames).  Launches counted
           per run as in the driver phase.  Checks the JAX drivers' frame
           names and counts, a decoded frame against the returned array,
           one ``--eval_det`` path frame on the card against every 8th
           pixel on the CPU (``REFERENCE_TOL``); logs s per frame at each
           size.
15. mesh   ``plnerf_torch.cli.extract_mesh.main`` on the driver phase's
           step-400 checkpoint at ``--mesh_res 512`` (134,217,728 points in
           64^3-point queries through the fp32 kernel, folded heads, zero
           view directions), the bbox from the unit-sphere ``.obj`` the
           phase writes (+-0.25), ``--adaptive_iso`` over threshold 10.
           Holds the grid through the kernel against its plain version on
           the card at 128^3 and at 160^3 in queries above ``FWD_CHUNK``
           (1e-4 x max(1, max sigma)), the card against the CPU at 32^3,
           native against numpy marching cubes on a 48^3 block of the
           512^3 grid the surface crosses (faces equal, verts 1e-6), the
           PLY read back, verts inside the bbox, a non-empty raw and
           cleaned mesh; logs the grid's s, points/s beside the bound, the
           kernel's launches and device ms (one profiled grid), the weight
           pack's share, marching-cubes / filter / PLY s, verts and faces
           before and after the filter, and peak device memory.
16. dp     data parallelism under ``torchrun --standalone --nproc_per_node
           1`` (NCCL, world size 1): the driver phase's recipe for 20
           steps and a resume to 40 (checkpoints at both, a val render at
           40), ``--task test`` and ``extract_mesh --mesh_res 128``, each
           launched as ``python -m`` of the driver by torchrun, against
           the same runs without it in this process: the logged metrics,
           both checkpoints' tensors, the test set's files, the val render
           and the PLY bit-equal, and the kernels' launch counts (read in
           the launched process) equal; ms per step of both.  With a
           second card, world size 2 against 1 with perturb off (losses
           1e-6 relative, parameters 1e-5 relative L2, the test files and
           the PLY of one checkpoint bit-equal); otherwise ``w2`` says
           it was not run.  Then the export phase's baked fp32 artifact
           through ``ServingRenderer.load(devices=[cuda:0, cuda:0])`` (and
           [cuda:0, cuda:1] with a second card): its three 32,768-ray
           requests and a 400x400 image bit-equal to one device.
17. dispatch ``--steps_per_dispatch``: first a census of the step
           flavours the drivers run (the NVS step in fp32 and bf16, the
           vanilla joint Adam, a pool slice, the grid's bf16 step, the
           depth step with camera embeddings, with and without the grid),
           each at full width, as eager steps and as the drivers' CUDA
           graph of a window (``train/graph.py``): one window of 8 steps
           under ``torch.cuda.set_sync_debug_mode("error")`` (a wait on
           the card inside it raises, staging included), then one traced
           (the host's waits per step by op chain, expected 0; device ms,
           busy share, and the fused kernels the card ran, 2 + 2 a step,
           a replay's included, with their device ms per step: the bf16
           flavours' backward data and weight passes beside PR 11's 6.57 /
           1.62).  Then the
           driver's recipes at N = 8 against N = 1 for 120 steps with
           precrop / constant quadrature at 30 / 60: fp32 and bf16 on the
           driver phases' sphere, fp32 with batching on a 100x100 sphere
           whose pool reshuffles inside the run, and the occ recipe (bf16)
           across a warm-up of 40; the depth recipe at N = 4 against N = 1
           for 40 steps on the multi-object scene at 100x100.  Each pair's
           final checkpoint (and grid) and its losses at the steps both
           logged must be bit-equal; at N > 1 every full window but each
           phase's first is a graph's replay.  The wrappers must count
           both kernels twice a step of the windows run eagerly, and the
           ``--profile 8`` windows of the fp32, bf16 and occ runs (at N
           = 8 a replay) hold no wait on the card and 2 + 2 fused kernels
           a step in the card's trace; each run's captures, replays, ms
           per step (the print records past step 24, and over replayed
           windows only) and each trace's host and device ms and busy
           share are printed beside the card's name and power limit.

Then one JSON line with every kernel's numbers, the card line, and the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without CUDA, without the repository beside it, or on any failure.
``--only bwd,train`` (or ``--only depth``, ``--only occ``) runs the build
and the named phases alone, in the order above, and prints no result
lines; ``video`` runs the driver and depth phases first, ``mesh`` the
driver phase (their checkpoints), ``dp`` the export phase (its
artifact).  ``--dp_worker`` is the dp phase's own entry for the processes
torchrun starts.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# the bf16 step's backward data and weight passes, device ms per step,
# before their wgmma redesign (PERF.md section 5, PR 11's profile)
PR11_BF16_BWD_MS = {"data": 6.57, "weight": 1.62}
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
R_CHUNK = 32768
N_COARSE, N_FINE = 128, 64
KERNEL_REPLACES = "plnerf/kernels/fused_mlp.py:186"   # _kernel
BWD_REPLACES = "plnerf/kernels/fused_mlp.py:345"      # _bwd_kernel
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# backward, relative L2 error per output: relu mask flips put the plain
# fp32 version itself ~1e-3 from a float64 evaluation (see _bwd_hold)
BWD_TOLERANCE = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
N_RAND = 1024                      # rays per train step (blender_linear)
# the JAX driver's step variants (run_plnerf.py:582,620): precrop for the
# first 500 steps, constant quadrature for the first 1000; cut to 30 / 60
PRECROP_STEPS, CONSTANT_STEPS, TRAIN_STEPS, BF16_STEPS = 30, 60, 90, 20
PROBE_ROWS = 8192 * 321            # the TPU probes' N
# probe kernel vs plain version, scaled by max|ref|: fp32 sums only
# (shape, independent) or a bf16 recast between dots (the rest)
# the card's eval_det render against the CPU's on the same weights and rays
# the artifact against from_params: equality expected (the same ATen ops
# and kernels on the same inputs); this bounds what a rounding difference
# in a traced op could give
EXPORT_TOL = 1e-5
EXPORT_HW = 400                    # the export phase's image
REFERENCE_TOL = {"rgb_map": 1e-3, "acc_map": 1e-3, "depth_map": 1e-2,
                 "rgb0": 1e-3, "depth0": 1e-2}
PROBE_TOLERANCE = {"sums": 1e-5, "recast": 2e-2}
# the driver phase: a Blender-layout sphere scene, cut-down cadences
DRIVER_VIEWS = {"train": 8, "val": 1, "test": 2}
DRIVER_SIZE = 400
LEGO_CAMERA_ANGLE_X = 0.6911112070083618
DRIVER_STEPS, DRIVER_RESUME_STEPS = 300, 400
DRIVER_PRINT = 50
# --profile on the resumed run: 5 steps from its fourth
DRIVER_PROFILE = 5
# LPIPS on the card against the CPU on the same arrays and weights (cuDNN
# pinned to fp32)
LPIPS_TOL = 1e-5
DRIVER_TRAIN = ["--precrop_iters", "50", "--constant_init", "100",
                "--i_print", str(DRIVER_PRINT), "--i_weights", "150",
                "--i_img", "150",
                "--i_testset", "1000000", "--i_video", "1000000"]
# the driver phase's fixed-distance sweep: one test view per distance
FIXED_DIST_VIEWS = 1
# the llff phase: the forward-facing fixture at the geometry factor 8 reads
# from a published nerf_llff_data scene (fern: 20 views at 3024 x 4032);
# 128 samples per ray (the fixture's 640 take ~40 s per view on one core)
LLFF_VIEWS, LLFF_FACTOR, LLFF_HW, LLFF_MARCH = 20, 8, (378, 504), 128
LLFF_STEPS, LLFF_PRINT = 300, 50
LLFF_TRAIN = ["--constant_init", "100", "--i_print", str(LLFF_PRINT),
              "--i_weights", "150", "--i_img", "150",
              "--i_testset", "1000000", "--i_video", "1000000"]
# the jpeg phase: the committed fixtures, the 12 MP file decoded 5 times,
# and the LLFF recipe from the 20-view JPEG capture at --factor 2 (1008x756
# sources to 378x504): 60 steps, a resume to 100, no val renders
JPEG_FIXTURES = os.path.join("tests", "data", "torch_jpeg")
JPEG_DECODES = 5
JPEG_STEPS, JPEG_RESUME_STEPS, JPEG_PRINT = 60, 100, 20
JPEG_TRAIN = ["--constant_init", "100", "--i_print", str(JPEG_PRINT),
              "--i_img", "1000000", "--i_testset", "1000000",
              "--i_video", "1000000"]
# the depth phase: the multi-object scene in the blender2_depth layout at
# 200x200 (lego's camera_angle_x), 10 train and 1 val views and 9 test
# views of which the loader reads 2 (a stride of 8); the depth recipe at
# full width with camera embeddings
DEPTH_VIEWS = {"train": 10, "val": 1, "test": 9}
DEPTH_SIZE = 200
DEPTH_STEPS, DEPTH_RESUME_STEPS, DEPTH_PRINT, DEPTH_FREEZE = 300, 350, 50, 150
DEPTH_CAM_EPOCHS = 3
DEPTH_TRAIN = ["--mode", "linear", "--N_samples", "128", "--N_importance",
               "64", "--N_rand", "1024", "--space_carving_weight", "0.007",
               "--freeze_ss", str(DEPTH_FREEZE), "--warm_start_nerf", "50",
               "--input_ch_cam", "4", "--opt_ch_cam",
               "--i_print", str(DEPTH_PRINT), "--i_img", "150",
               "--i_weights", "150"]
# the depth phase's two seeded runs past the warm start (50), and its run
# of the depth driver with the occupancy grid
DEPTH_REPEAT_STEPS = 70
DEPTH_OCC_STEPS, DEPTH_OCC_WARMUP = 60, 20
# the occ phase: configs/blender_linear_occ.txt on the driver phase's
# sphere, its warm-up (500) and precrop cut as the driver phase cuts them;
# two seeded runs of its first guided steps
OCC_WARMUP = 100
# 300 steps and a resume to 1200: on this scene the grid starts to carve
# only near step 1000, where the field's fog clears (occ_ray_frac 0.69
# to step 900, 0.63 at 1000, 0.29 at 1500: tools/occ_quality.py, PERF.md)
OCC_STEPS, OCC_RESUME_STEPS = 300, 1200
# both arms print every 10 steps, so the first guided print (110) reads
# the grid 10 steps after it engages; checkpoints every 300, val renders
# every 600
OCC_PRINT = 10
OCC_TRAIN = ["--precrop_iters", "50", "--constant_init", "100",
             "--i_print", str(OCC_PRINT), "--i_weights", "300",
             "--i_img", "600", "--i_testset", "1000000",
             "--i_video", "1000000"]
OCC_ARM = OCC_TRAIN + ["--occ_warmup", str(OCC_WARMUP)]
OCC_REPEAT_STEPS, OCC_REPEAT_WARMUP = 60, 20
OCC_REPEAT = DRIVER_TRAIN + [
    "--i_print", "10", "--i_img", "1000000", "--i_weights",
    str(OCC_REPEAT_STEPS), "--occ_warmup", str(OCC_REPEAT_WARMUP),
    "--num_iterations", str(OCC_REPEAT_STEPS)]
# the video phase: the driver phase's step-400 checkpoint renders the 40
# hemisphere poses at render factor 4 (100x100), the test views at 400x400
# (--render_only --render_test), and a copy of its run continues 20 steps
# with --i_video 10 (firing once, at 410); the depth phase's step-350
# checkpoint renders the 40 poses of its video split at 200x200
VIDEO_FRAMES, VIDEO_FACTOR, VIDEO_CONT_STEPS, VIDEO_EVERY = 40, 4, 20, 10
# the mesh phase: the reference's 512^3 grid in 64^3-point queries over the
# GT sphere's bbox (+-0.25); native marching cubes held against numpy on a
# 48^3 block of it
MESH_RES, MESH_CHUNK, MESH_THRESHOLD, MESH_BLOCK = 512, 64 ** 3, 10.0, 48
# the grid through the kernel held against its plain version on the card
# at (resolution, query chunk): 128^3 in the CLI's queries, and 160^3 in
# queries of 3 x 2^20 points, above the fp32 kernel's FWD_CHUNK (2^21), so
# one call runs its ragged two-chunk schedule; the card against the CPU at
# 32^3
MESH_HOLDS = {"kernel_vs_plain_128": (128, MESH_CHUNK),
              "kernel_vs_plain_160_big": (160, 3 << 20)}
MESH_CPU_RES = 32
# pred_hyp, a depth along the ray, at the depth maps' tolerance
HYP_TOL = dict(REFERENCE_TOL, pred_hyp=1e-2)
# the dp phase: the driver phase's recipe for 20 steps and a resume to 40
# (a checkpoint at each, a val render at 40, prints every 10), its test
# task and a 128^3 mesh, with and without torchrun
DP_STEPS, DP_RESUME_STEPS, DP_PRINT = 20, 40, 10
DP_TRAIN = DRIVER_TRAIN + ["--i_print", str(DP_PRINT), "--i_weights",
                           str(DP_STEPS), "--i_img", str(DP_RESUME_STEPS)]
DP_MESH = ["--mesh_res", "128", "--adaptive_iso", "--mesh_threshold", "10",
           "--min_component_faces", "100", "--bbox_min", "-1.5", "-1.5",
           "-1.5", "--bbox_max", "1.5", "1.5", "1.5"]
DP_TIMEOUT_S = 300
# and the recipe in bf16 at --steps_per_dispatch 8 for 40 steps, all in the
# precrop's phase: five full windows (the first eager, the second captured,
# every window from it on replayed with its all-reduce inside), a val
# render and a checkpoint at 40, the --profile window 9-16 a replay
DP_N, DP_N_STEPS = 8, 40
DP_N_TRAIN = DRIVER_TRAIN + [
    "--mlp_dtype", "bfloat16", "--steps_per_dispatch", str(DP_N),
    "--i_print", str(DP_N), "--i_weights", str(DP_N_STEPS), "--i_img",
    str(DP_N_STEPS), "--num_iterations", str(DP_N_STEPS), "--profile",
    str(DP_N)]
DP_N_PLAN = ["first", "capture"] + ["replay"] * (DP_N_STEPS // DP_N - 2)
DRIVER, MESH = "plnerf_torch.cli.run_plnerf", "plnerf_torch.cli.extract_mesh"
PROBE_REPLACES = {"shape": "tools/dot_decompose.py:89",     # make_shape_kernel
                  "mixed": "tools/dot_decompose.py:161",    # make_mixed_kernel
                  "merged": "tools/dot_decompose.py:230",   # make_merged_kernel
                  "mosaic": "tools/mosaic_probe.py:22"}     # make_kernel


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    from plnerf_torch.utils.profile import timed_ms

    return timed_ms(fn, torch.device("cuda"), reps)


def macs_per_point(cfg, head: int) -> int:
    """The MLP's multiply-adds per point on unpadded widths."""
    from plnerf_torch.kernels import fused_mlp

    W, in_ch = cfg.netwidth, cfg.input_ch
    vch = cfg.input_ch_views + cfg.input_ch_cam
    macs = in_ch * W + (cfg.netdepth - 1) * W * W
    macs += sum(in_ch * W for i in range(cfg.netdepth) if (i - 1) in cfg.skips)
    if head == fused_mlp.SPLIT:
        macs += W * (W + 1) + (W + vch) * (W // 2) + (W // 2) * 3
    elif head == fused_mlp.FOLDED:
        macs += W * (W // 2 + 1) + vch * (W // 2) + (W // 2) * 3
    else:
        macs += W * cfg.output_ch
    return macs


def bound(p, x, v, n: int, cfg) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (inputs read once, raw written once) over HBM bandwidth and its FLOPs
    over the card's peak for the operand type."""
    wbuf, bbuf = p.flat()
    nbytes = sum(t.numel() * t.element_size() for t in (x, wbuf, bbuf)
                 if t is not None) + n * 4 * 4
    if v is not None:
        nbytes += v.numel() * v.element_size()
    flops = 2.0 * macs_per_point(cfg, p.head) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[p.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    from plnerf_torch.kernels import build, fused_mlp

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(build.build, names))
    build_s = round(time.perf_counter() - t0, 3)
    # dynamic shared memory per CTA (set at launch, not in ptxas's count)
    # of the 8x256 MLP: input 64, views 32
    fwd, bwd = fused_mlp._library(), fused_mlp._bwd_library()
    smem = {"fused_mlp_fwd": {dt: fwd.plnerf_fused_mlp_fwd_smem(64, 256, 32, b)
                              for dt, b in (("float32", 0), ("bfloat16", 1))},
            "fused_mlp_bwd": {dt: bwd.plnerf_fused_mlp_bwd_smem(8, 64, 256, 32,
                                                                b)
                              for dt, b in (("float32", 0), ("bfloat16", 1))}}
    log("env", card=card_line(), torch=torch.__version__,
        cuda=torch.version.cuda, kernels_built=names, build_s=build_s,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        allow_bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
        ptxas={name: build.ptxas_info(name) for name in names},
        dynamic_smem_8x256=smem)


def _kernel_inputs(cfg, R, S, fold, dtype, dev, seed):
    from plnerf_torch.core.encoding import embed
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.kernels import fused_mlp

    g = torch.Generator(device=dev).manual_seed(seed)
    m = NeRF(cfg, g, device=dev)
    pts = torch.randn(R, S, 3, generator=g, device=dev)
    ve = None
    if cfg.use_viewdirs:
        vd = torch.nn.functional.normalize(
            torch.randn(R, 3, generator=g, device=dev), dim=-1)
        ve = embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :]
    pe = embed(pts, cfg.multires, cfg.pi_bands)
    p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
    return m, pe, ve, p, x, v, v_div


def _hold(key, p, x, v, v_div, errs, acts=None) -> None:
    """The kernel against its plain version on the same inputs; records
    the max abs error under ``key`` and raises past the tolerance, which
    scales with max(1, max|raw|).  ``acts``: the activations buffer a
    training forward was given; the call then keeps its activations in one
    of that shape, as training's does."""
    from plnerf_torch.kernels import fused_mlp

    got = fused_mlp.forward_cuda(
        p, x, v, v_div, None if acts is None else torch.empty_like(acts))
    torch.cuda.synchronize()
    ref = fused_mlp.forward_plain(p, x, v, v_div)
    err = float((got - ref).abs().max())
    errs[key] = err
    scale = float(ref.abs().max())
    if not (torch.isfinite(got).all() and
            err <= TOLERANCE[p.dtype] * max(1.0, scale)):
        raise AssertionError(f"kernel {key}: max abs err {err} (scale "
                             f"{scale}) over tolerance {TOLERANCE[p.dtype]}")


def _launch_ms(fn, dev, pattern: str, reps: int = 2) -> list:
    """Device ms of every kernel launch whose name holds ``pattern`` in one
    call of ``fn``, in launch order, the mean over ``reps`` calls in a
    torch.profiler window after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    ks = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and pattern in e.name), key=lambda e: e.time_range.start)
    per = len(ks) // reps
    return [statistics.mean(ks[r * per + i].time_range.elapsed_us()
                            for r in range(reps)) / 1e3 for i in range(per)]


def phase_kernel(dev):
    """Returns (max abs error over every comparison, split fp32 times)."""
    from plnerf_torch.core.config import ModelConfig
    from plnerf_torch.core.mlp import apply_mlp
    from plnerf_torch.kernels import fused_mlp

    t0 = time.perf_counter()
    full = ModelConfig()                      # 8x256, in 63, views 27
    plain = ModelConfig(use_viewdirs=False)
    dtypes = (torch.float32, torch.bfloat16)
    errs = {}
    with torch.no_grad():
        # every head schedule at 65,537 points = 1 ray x 65,537 samples
        # (ragged last tile), then the main path's own shapes: the coarse
        # (128 samples) and fine (192) passes of a 32,768-ray chunk
        for name, cfg, fold in (("split", full, False),
                                ("folded", full, True),
                                ("plain", plain, False)):
            for dtype in dtypes:
                _, _, _, p, x, v, v_div = _kernel_inputs(
                    cfg, 1, 65537, fold, dtype, dev, seed=1)
                _hold(f"{name}_{str(dtype)[6:]}_65537", p, x, v, v_div, errs)
        for dtype in dtypes:
            _, _, _, p, x, v, v_div = _kernel_inputs(
                full, R_CHUNK, N_COARSE, False, dtype, dev, seed=3)
            _hold(f"split_{str(dtype)[6:]}_coarse", p, x, v, v_div, errs)
            del p, x, v

        # one fine pass of a 32,768-ray chunk: 192 samples per ray
        times = {}
        S = N_COARSE + N_FINE
        n = R_CHUNK * S
        for dtype in dtypes:
            for fold in (False, True):
                m, pe, ve, p, x, v, v_div = _kernel_inputs(
                    full, R_CHUNK, S, fold, dtype, dev, seed=2)
                key = f"{'folded' if fold else 'split'}_{str(dtype)[6:]}"
                _hold(key + "_fine", p, x, v, v_div, errs)
                entry = {"kernel_ms": cuda_ms(
                    lambda: fused_mlp.forward_cuda(p, x, v, v_div))}
                if dtype == torch.float32:
                    # one fp32_kernel launch per product and chunk
                    entry["launch_ms"] = _launch_ms(
                        lambda: fused_mlp.forward_cuda(p, x, v, v_div), dev,
                        "fp32_kernel")
                    entry["chunks"] = len(fused_mlp.fwd_chunks(n, v_div))
                entry["bound_ms"], entry["bound_by"] = bound(p, x, v, n, full)
                if not fold:
                    entry["plain_ms"] = cuda_ms(
                        lambda: fused_mlp.forward_plain(p, x, v, v_div), 3)
                    entry["library_ms"] = cuda_ms(
                        lambda: apply_mlp(m, pe, ve, full, dtype), 3)
                times[key] = entry
                del m, pe, ve, p, x, v
                torch.cuda.empty_cache()
        log("kernel_check", max_abs_err=errs,
            tolerance={"float32": TOLERANCE[torch.float32],
                       "bfloat16": TOLERANCE[torch.bfloat16]},
            note="tolerance scales with max(1, max|raw|)")
        log("kernel_time", points=n, rays=R_CHUNK, samples=S, card=card_line(),
            phase_s=time.perf_counter() - t0, times=times,
            note="launch_ms: device ms of each fp32_kernel launch of one "
                 "call (one per product, chunk by chunk)")
    return max(errs.values()), times["split_float32"]


def _probe_checks(dev) -> dict:
    """Every probe kernel against its plain version on the same inputs at
    PROBE_ROWS rows, the size the probe path runs, for every shape, variant
    and row tile; returns the max abs error by kernel.  Raises once every
    case has been read if any is over its tolerance."""
    from plnerf_torch.kernels import dot_probe as dp
    from plnerf_torch.tools import dot_decompose as dd, mosaic_probe as mp

    n, reps = PROBE_ROWS, dd.REPS
    sums, recast = PROBE_TOLERANCE["sums"], PROBE_TOLERANCE["recast"]
    shapes = [(k, m) for k, m, _ in dd.WALK] + [(384, 256), (384, 128)]
    errs, checks, failed = {}, {}, []

    def hold(kernel, key, got, ref, tol):
        """Records the max abs error per kernel and, beside max|ref|, per
        case; a case past ``tol`` x max|ref| goes into ``failed``."""
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        checks[key] = [err, scale]
        if not (torch.isfinite(got).all() and err <= tol * scale):
            failed.append(key)

    with torch.no_grad():
        for k, m in shapes:
            x, ws = dd.inputs(n, k, [(k, m)] * reps, dev, seed=k + m)
            ref = dp.shape_plain(x, ws)
            for tile in dp.SHAPE_TILES:
                hold("shape", f"shape_{k}x{m}_t{tile}",
                     dp.shape_cuda(x, ws, tile), ref, sums)
        x, ws = dd.inputs(n, 128, dd.MIXED_SHAPES, dev, seed=1)
        ref = dp.mixed_plain(x, ws)
        for tile in dp.TILES:
            hold("mixed", f"mixed_t{tile}", dp.mixed_cuda(x, ws, tile), ref,
                 recast)
        x, ws = dd.inputs(n, 128, dd.MERGED_SHAPES, dev, seed=2)
        ref = dp.merged_plain(x, ws)
        for concat, tiles in ((False, dp.TILES), (True, dp.CONCAT_TILES)):
            for tile in tiles:
                hold("merged",
                     f"merged_{'concat' if concat else 'scratch'}_t{tile}",
                     dp.merged_cuda(x, ws, tile, concat), ref, recast)
        x, ws = mp.inputs(n, dev, seed=3)
        for variant in dp.VARIANTS:
            ref = dp.mosaic_plain(x, ws, variant)
            for tile in dp.mosaic_tiles(variant):
                hold("mosaic", f"mosaic_{variant}_t{tile}",
                     dp.mosaic_cuda(x, ws, tile, variant), ref,
                     sums if variant == "independent" else recast)
        del x, ws, ref
    torch.cuda.empty_cache()
    log("probe_check", rows=n, max_abs_err=errs, max_abs_err_and_scale=checks,
        tolerance=PROBE_TOLERANCE,
        note="tolerance scales with max|ref|; 'sums' for shape and "
             "mosaic independent, 'recast' for the rest")
    if failed:
        raise AssertionError("probe kernels over tolerance: " + ", ".join(
            f"{key} err {checks[key][0]} (max|ref| {checks[key][1]})"
            for key in failed))
    return errs


def _library_call(name, x, ws):
    """A cuBLAS call (bf16 in and out, fp32 sums) computing probe ``name``
    on (x, ws): the yardstick, never called by the port.  The shape probe
    is one GEMM, x repeated along K against the weights stacked (operands
    built here, outside the timing); the walks are torch.matmul / addmm
    chains on their own shapes."""
    mm = torch.matmul
    w = ws

    def mixed():
        h = mm(x, w[0])
        for i in range(1, 5):
            h = mm(h, w[i])
        h = mm(torch.addmm(mm(x, w[5]), h, w[6]), w[7])
        fa = mm(mm(h, w[8]), w[9])
        hv = torch.addmm(mm(x, w[11]), fa[:, :256], w[10])
        return torch.cat([mm(hv, w[12]), fa[:, 256:]], 1)

    def merged():
        h = mm(x, w[0])
        for i in range(1, 5):
            h = mm(h, w[i])
        h = mm(mm(mm(torch.cat([h, x], 1), w[5]), w[6]), w[7])
        fa = mm(h, w[8])
        hv = mm(torch.cat([fa[:, :256], x], 1), w[9])
        return torch.cat([mm(hv, w[10]), fa[:, 256:]], 1)

    def mosaic():
        h = x
        for wi in w:
            h = mm(h, wi)
        return h

    if name == "shape":
        xs, wst = torch.cat([x] * len(ws), 1), torch.cat(list(ws), 0)
        return lambda: mm(xs, wst)
    return {"mixed": mixed, "merged": merged, "mosaic": mosaic}[name]


def phase_probes(dev):
    """Returns (launches by probe kernel, fused forward launches, one
    entry of the kernels line per probe kernel)."""
    from plnerf_torch.kernels import dot_probe as dp, fused_mlp
    from plnerf_torch.tools import dot_decompose as dd, mosaic_probe as mp

    t0 = time.perf_counter()
    errs = _probe_checks(dev)
    n, tile = PROBE_ROWS, dd.T
    torch.cuda.synchronize()
    for k in dp.launches:                     # probe path starts here
        dp.launches[k] = 0
    fused_mlp.launches = 0
    with torch.no_grad():
        res = {"A": dd.experiment_shapes(n, dev, tile),
               "B": dd.experiment_mixed(n, dev, tile)}
        res.update(D=dd.experiment_tiles(n, dev, res["B"]),
                   E=dd.experiment_merged(n, dev, tile, res["B"]),
                   C=dd.experiment_real(n, dev),
                   mosaic=mp.experiment(n, dev),
                   shape_tiles=[dd.run_shape(256, 256, dd.REPS, t, n, dev)
                                for t in dp.SHAPE_TILES])
    launches = dict(dp.launches)              # probe path ends here
    fwd_launches = fused_mlp.launches
    if min(launches.values()) < 1 or fwd_launches < 1:
        raise AssertionError(f"the probe path launched no kernel: {launches}"
                             f", fused forward {fwd_launches}")

    # the shape kernel at 256 rows per CTA, the tile its A/B kept (every
    # tile's time is in probe_decomposition); mosaic chained at the
    # forward's tile
    shape_r = res["shape_tiles"][-1]
    scratch = {(r["operand"], r["tile"]): r["ms"] for r in res["E"]["merged"]}
    chained = next(r for r in res["mosaic"]
                   if r["tile"] == tile and r["variant"] == "chained")
    real = {r["heads"]: r["ms"] for r in res["C"]["forward"]}
    walk = res["A"]["predicted_walk_ms"]
    log("probe_decomposition", card=card_line(), rows=n, tile=tile,
        predicted_walk_ms_from_shapes=walk,
        real_forward_bf16_ms=real,
        predicted_over_real={h: walk / ms for h, ms in real.items()},
        mixed_ms=res["B"]["ms"], mixed_tflop_per_s=res["B"]["tflop_per_s"],
        predicted_over_mixed=walk / res["B"]["ms"],
        merged_scratch_ms=scratch[("scratch", tile)],
        merged_like_for_like_ms={f"{o}_t{t}": ms
                                 for (o, t), ms in scratch.items()},
        shape_256x256_ms_by_tile={r["tile"]: r["ms"]
                                  for r in res["shape_tiles"]},
        note="A (the per-shape sum), B (the mixed walk) and C (the real "
             "bf16 forward) run one wgmma product code (wgmma_core.cuh)")
    log("probe_time", card=card_line(), rows=n, experiments=res)

    cases = {   # kernel: (its ms, shapes, x width, out width, plain)
        "shape": (shape_r["ms"], [(256, 256)] * dd.REPS, 256, 256,
                  lambda x, ws: dp.shape_plain(x, ws)),
        "mixed": (res["B"]["ms"], dd.MIXED_SHAPES, 128, 256, dp.mixed_plain),
        "merged": (scratch[("scratch", tile)], dd.MERGED_SHAPES, 128, 256,
                   dp.merged_plain),
        "mosaic": (chained["ms"], [(256, 256)] * mp.D, 256, 256,
                   lambda x, ws: dp.mosaic_plain(x, ws, "chained")),
    }
    entries = []
    for name, (ms, shapes, k_in, n_out, plain) in cases.items():
        x, ws = dd.inputs(n, k_in, shapes, dev)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: plain(x, ws), 3)
            library_ms = cuda_ms(_library_call(name, x, ws), 3)
        bound_ms, bound_by = dp.bound(*dp.cost(n, shapes, k_in, n_out))
        entries.append({
            "name": f"dot_probe_{name}", "route": "cuda",
            "source": "plnerf_torch/kernels/csrc/dot_probe.cu",
            "replaces": PROBE_REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
        del x, ws
        torch.cuda.empty_cache()
    log("probe_kernels", card=card_line(), rows=n, tile=tile,
        shape_tile=shape_r["tile"], phase_s=time.perf_counter() - t0,
        note="ms: shape (256, 256) x13 at shape_tile, mixed, merged scratch "
             "and mosaic chained at the row tile, shape and mosaic "
             "including the pack of their weights; max_abs_err: the worst "
             "case of probe_check at the same rows; library: for shape one "
             "GEMM [N, 13 x 256] @ [13 x 256, 256], else a torch.matmul / "
             "addmm chain, bf16 in and out, fp32 sums", kernels=entries)
    return launches, fwd_launches, entries


def _blender_rays(dev, n_rays, seed):
    """Rays of a random Blender test camera (radius 4, looking at the
    origin, 800x800 intrinsics): ``n_rays`` random pixels."""
    from plnerf_torch.core import rays as raysmod
    from plnerf_torch.core.render import make_ray_batch

    c2w, K = _blender_camera(seed)
    ro, rd = raysmod.get_rays(800, 800, K, torch.as_tensor(c2w, device=dev))
    packed, _ = make_ray_batch(ro, rd, 2.0, 6.0, True)
    idx = torch.as_tensor(np.random.default_rng(seed).choice(
        800 * 800, n_rays, replace=False), device=dev)
    return packed[idx]


def _blender_camera(seed):
    rng = np.random.default_rng(seed)
    theta, phi = rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 1.2)
    eye = 4.0 * np.array([np.cos(theta) * np.cos(phi),
                          np.sin(theta) * np.cos(phi), np.sin(phi)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.stack([right, up, -fwd, eye], 1).astype(np.float32)
    focal = 0.5 * 800 / np.tan(0.5 * 0.6911112)      # Blender camera_angle_x
    K = np.array([[focal, 0, 400], [0, focal, 400], [0, 0, 1]], np.float32)
    return c2w, K


def _renderers(dev):
    from plnerf_torch.core.config import ModelConfig, RenderConfig
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.eval.images import test_render_config
    from plnerf_torch.serving.runtime import ServingRenderer

    mcfg = ModelConfig()
    base = RenderConfig(n_samples=N_COARSE, n_importance=N_FINE,
                        mode="linear", color_mode="midpoint",
                        white_bkgd=True, use_fused_mlp=True)
    g = torch.Generator(device=dev).manual_seed(0)
    pc, pf = NeRF(mcfg, g, device=dev), NeRF(mcfg, g, device=dev)
    test = ServingRenderer.from_params(pc, pf, mcfg, test_render_config(base),
                                       chunk=R_CHUNK, device=dev)
    det = ServingRenderer.from_params(
        pc, pf, mcfg, test_render_config(base, perturb=False),
        chunk=R_CHUNK, device=dev)
    bf16 = ServingRenderer.from_params(
        pc, pf, mcfg, test_render_config(base, mlp_dtype="bfloat16"),
        chunk=R_CHUNK, device=dev)
    return test, det, bf16


def _check_maps(out, n):
    """Finite maps of n rows with rgb in [0, 1 + 1e-5].  The one exception
    is the reference's own 0/0: disparity 1/max(1e-10, depth/acc) is NaN
    on a ray whose weights are all 0; returns the count of such rays."""
    empty = out["acc_map"].reshape(n) == 0
    for k, v in out.items():
        ok = np.isfinite(v).reshape(n, -1).all(-1)
        if k == "disp_map":
            ok |= empty
        if v.shape[0] != n or not ok.all():
            raise AssertionError(f"{k}: shape {v.shape} or non-finite")
    rgb = out["rgb_map"]
    if rgb.min() < 0.0 or rgb.max() > 1.0 + 1e-5:
        raise AssertionError(f"rgb_map outside [0, 1]: {rgb.min()} "
                             f"{rgb.max()}")
    return int(empty.sum())


def phase_slice(dev):
    from plnerf_torch.kernels import fused_mlp

    test, det, bf16 = _renderers(dev)
    requests = [_blender_rays(dev, R_CHUNK, seed) for seed in range(3)]
    torch.cuda.synchronize()

    fused_mlp.launches = 0                    # main path starts here
    req = []
    # three fp32 requests (the recipe's mlp_dtype), then one in bf16
    for seed, rays, srv in [(0, requests[0], test), (1, requests[1], test),
                            (2, requests[2], test), (0, requests[0], bf16)]:
        before = fused_mlp.launches
        t0 = time.perf_counter()
        out = srv.render_rays(rays, seed=seed)
        dt = time.perf_counter() - t0
        empty = _check_maps(out, R_CHUNK)
        if fused_mlp.launches - before != 2:
            raise AssertionError("expected 2 kernel launches per chunk")
        req.append({"seed": seed, "mlp_dtype": srv.rcfg.mlp_dtype,
                    "rays": R_CHUNK, "s": dt, "rays_per_s": R_CHUNK / dt,
                    "empty_rays": empty,
                    "mean_acc": float(out["acc_map"].mean())})

    c2w, K = _blender_camera(7)
    imgs, img_s = [], []
    for _ in range(2):
        before = fused_mlp.launches
        t0 = time.perf_counter()
        imgs.append(det.render_image(c2w, (400, 400, K[0, 0] / 2),
                                     np.array([[K[0, 0] / 2, 0, 200],
                                               [0, K[0, 0] / 2, 200],
                                               [0, 0, 1]], np.float32)))
        img_s.append(time.perf_counter() - t0)
        n_chunks = -(-400 * 400 // R_CHUNK)
        if fused_mlp.launches - before != 2 * n_chunks:
            raise AssertionError("expected 2 kernel launches per chunk")
    launches = fused_mlp.launches             # main path ends here
    img_empty = _check_maps({k: v.reshape(400 * 400, -1)
                             for k, v in imgs[0].items()}, 400 * 400)
    for k in imgs[0]:
        if not np.array_equal(imgs[0][k], imgs[1][k], equal_nan=True):
            raise AssertionError(f"eval_det renders differ in {k}")
    log("slice", card=card_line(), requests=req, image="400x400",
        image_s=img_s, image_empty_rays=img_empty, images_identical=True,
        launches=launches)
    return launches


def phase_reference(dev):
    """The card's serving render against the CPU's (the kernel's plain
    version) on the same weights and rays, eval_det."""
    from plnerf_torch.serving.runtime import ServingRenderer

    _, det, _ = _renderers(dev)
    rays = _blender_rays(dev, 512, 11)
    gpu = det.render_rays(rays)
    cpu_srv = ServingRenderer.from_params(
        det.params_c.to("cpu"), det.params_f.to("cpu"), det.mcfg, det.rcfg,
        chunk=512, device="cpu")
    cpu = cpu_srv.render_rays(rays.cpu())
    errs = _card_vs_cpu(gpu, cpu)
    log("reference", rays=512, max_abs_err=errs, tolerance=REFERENCE_TOL)


def _max_diff(got: dict, ref: dict) -> dict:
    """Max abs difference of every map, NaN where both are NaN counted as
    equal (disparity's 0/0 on an empty ray)."""
    out = {}
    for k, r in ref.items():
        d = np.abs(got[k].astype(np.float64) - r.astype(np.float64))
        both = np.isnan(got[k]) & np.isnan(r)
        out[k] = float(np.where(both, 0.0, d).max())
    return out


def _hold_maps(got: dict, ref: dict, what: str) -> dict:
    """``got`` against ``ref`` within EXPORT_TOL (equality expected: the
    same ATen ops and the same kernel on the same inputs); returns the max
    differences."""
    if set(got) != set(ref):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(ref)}")
    diff = _max_diff(got, ref)
    for k, r in ref.items():
        if not np.allclose(got[k], r, rtol=EXPORT_TOL, atol=EXPORT_TOL,
                           equal_nan=True):
            raise AssertionError(f"{what}: {k} differs by {diff[k]}")
    return diff


def phase_export(dev, keep=None):
    """The serving artifact of the slice phase's weights: exported and
    loaded for fp32 and bf16, baked and args weights, each held against
    ``from_params`` on three 32,768-ray requests (perturb kept, seeds 0-2)
    and one 400x400 image, through the chunk module and the whole-batch
    module.  Returns the forward launches of the artifacts' calls.
    ``keep``: a directory for the artifacts (``keep/float32_baked``, ...,
    left for the dp phase), else a temporary one."""
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.serving import export as SE
    from plnerf_torch.serving.runtime import ServingRenderer

    test, _, bf16 = _renderers(dev)
    requests = [_blender_rays(dev, R_CHUNK, seed) for seed in range(3)]
    c2w, K = _blender_camera(7)
    f = K[0, 0] * EXPORT_HW / 800
    hwf = (EXPORT_HW, EXPORT_HW, f)
    c = EXPORT_HW / 2
    K2 = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)

    def run(srv, fused=True):
        """The three requests, then the image, timed, with the forward
        launches they made."""
        saved = srv._fused
        if not fused:
            srv._fused = None
        try:
            outs, ms, before = [], [], fused_mlp.launches
            for seed, rays in enumerate(requests):
                t0 = time.perf_counter()
                outs.append(srv.render_rays(rays, seed=seed))
                ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            img = srv.render_image(c2w, hwf, K2, seed=0)
            img_ms = (time.perf_counter() - t0) * 1e3
        finally:
            srv._fused = saved
        return outs, ms, img, img_ms, fused_mlp.launches - before

    refs = {}
    for name, srv in (("float32", test), ("bfloat16", bf16)):
        run(srv)                                   # warm
        refs[name] = run(srv)
        _check_maps(refs[name][0][0], R_CHUNK)

    arts, rec = {}, {}
    with tempfile.TemporaryDirectory(prefix="plnerf_serving_") as tmp:
        for name, srv in (("float32", test), ("bfloat16", bf16)):
            for mode in ("baked", "args"):
                out = os.path.join(keep or tmp, f"{name}_{mode}")
                t0 = time.perf_counter()
                man = SE.export_renderer(
                    srv.params_c, srv.params_f, srv.mcfg, srv.rcfg, out,
                    chunk=R_CHUNK, fused_n_rays=EXPORT_HW ** 2,
                    weights_mode=mode)
                export_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                arts[name, mode] = ServingRenderer.load(out, device=dev)
                load_s = time.perf_counter() - t0
                size = sum(os.path.getsize(os.path.join(out, x))
                           for x in os.listdir(out))
                rec[f"{name}_{mode}"] = {
                    "export_s": export_s, "load_s": load_s,
                    "artifact_mb": size / 2 ** 20,
                    "draw_inputs": [d["name"] for d in man["draw_inputs"]]}
        for art in arts.values():
            run(art)                               # warm
        torch.cuda.synchronize()

        fused_mlp.launches = 0                     # main path starts here
        got = {key: (run(art), run(art, fused=False))
               for key, art in arts.items()}
        launches = fused_mlp.launches              # main path ends here

    for (name, mode), (whole, chunked) in got.items():
        ref = refs[name]
        r = rec[f"{name}_{mode}"]
        # each path: 3 requests of one chunk and an image of 5 chunks, two
        # passes each: from_params's count
        for path, (outs, ms, img, img_ms, n) in (("whole_batch", whole),
                                                 ("chunks", chunked)):
            if n != ref[4] or n < 1:
                raise AssertionError(f"{name} {mode} {path}: {n} forward "
                                     f"launches, from_params {ref[4]}")
            diffs = [_hold_maps(o, q, f"{name} {mode} request {i}")
                     for i, (o, q) in enumerate(zip(outs, ref[0]))]
            diffs.append(_hold_maps(img, ref[2], f"{name} {mode} image"))
            r[path] = {"launches": n, "ms_per_request": ms,
                       "image_ms": img_ms,
                       "max_abs_diff": max(max(d.values()) for d in diffs)}
        r["from_params"] = {"launches": ref[4], "ms_per_request": ref[1],
                            "image_ms": ref[3]}
    log("export", card=card_line(), rays_per_request=R_CHUNK,
        image=f"{EXPORT_HW}x{EXPORT_HW}", tolerance=EXPORT_TOL, artifacts=rec,
        launches=launches)
    return launches


def phase_interop(dev, state):
    """The train phase's state through a reference ``.tar``: written by
    ``save_reference_checkpoint`` (the fine Adam's moments in the
    reference's order), read back on the card by
    ``load_reference_checkpoint`` and by ``restore_checkpoint`` into a
    fresh state, which must hold the same networks and moments and render
    the same 512 rays bit for bit."""
    from plnerf_torch.checkpoint import convert_torch
    from plnerf_torch.checkpoint import io as ckio
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.eval.images import test_render_config
    from plnerf_torch.serving.runtime import ServingRenderer
    from plnerf_torch.train.step import init_state

    lin, _ = _train_setups()
    sd = state.state_dict()
    with tempfile.TemporaryDirectory(prefix="plnerf_tar_") as tmp:
        path = os.path.join(tmp, f"{state.step:06d}.tar")
        t0 = time.perf_counter()
        kind = convert_torch.save_reference_checkpoint(
            path, state.step, sd["params_coarse"], sd["params_fine"],
            fine_adam=convert_torch.adam_moments(
                sd["opt_fine"], [sd["params_fine"]]))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = convert_torch.load_reference_checkpoint(path, dev)
        load_s = time.perf_counter() - t0
        fresh = init_state(torch.Generator(device=dev).manual_seed(1), lin,
                           dev)
        ckio.restore_checkpoint(path, fresh, dev)
        size = os.path.getsize(path)
    if kind != "real Adam moments" or loaded["step"] != state.step:
        raise AssertionError(f"{kind}, step {loaded['step']}")
    nets = []
    for key in ("params_coarse", "params_fine"):
        net = NeRF(lin.mcfg, device=dev)
        net.load_state_dict(loaded[key])
        nets.append(net)
    for a, b in ((fresh.params_coarse, state.params_coarse),
                 (fresh.params_fine, state.params_fine)):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            if not torch.equal(p, q):
                raise AssertionError(f"restored {n} differs")
    ps = [p for g in state.opt_fine.param_groups for p in g["params"]]
    qs = [p for g in fresh.opt_fine.param_groups for p in g["params"]]
    for p, q in zip(ps, qs):
        for slot in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(state.opt_fine.state[p][slot],
                               fresh.opt_fine.state[q][slot]):
                raise AssertionError(f"restored Adam {slot} differs")
    rcfg = test_render_config(lin.rcfg, perturb=False)
    rays = _blender_rays(dev, 512, 13)
    ref = ServingRenderer.from_params(
        state.params_coarse, state.params_fine, lin.mcfg, rcfg, chunk=512,
        device=dev).render_rays(rays)
    diffs = {}
    for name, (pc, pf) in (("load_reference_checkpoint", nets),
                           ("restore_checkpoint", (fresh.params_coarse,
                                                   fresh.params_fine))):
        got = ServingRenderer.from_params(pc, pf, lin.mcfg, rcfg, chunk=512,
                                          device=dev).render_rays(rays)
        for k in ref:
            if not np.array_equal(got[k], ref[k], equal_nan=True):
                raise AssertionError(f"{name}: {k} is not bit-equal")
        diffs[name] = _max_diff(got, ref)
    log("interop", step=state.step, tar_mb=size / 2 ** 20, kind=kind,
        save_s=save_s, load_s=load_s, rays=512, bit_equal=True,
        max_abs_diff=diffs)


def _card_vs_cpu(card: dict, cpu: dict, tol=REFERENCE_TOL) -> dict:
    """Max abs errors of the card's maps against the CPU's, held to
    ``tol``."""
    errs = {}
    for k, lim in tol.items():
        errs[k] = float(np.abs(card[k] - cpu[k]).max())
        if errs[k] > lim:
            raise AssertionError(f"{k}: card vs CPU {errs[k]} > {lim}")
    return errs


def bwd_flops_per_point(cfg, head: int, recompute: bool) -> int:
    """Exact FLOPs per point of the backward kernel on unpadded widths:
    every dense layer's K x N multiply-adds twice (the data grad da @ W^T,
    the weight grad A^T @ da) and, where the kernel recomputes the forward
    (bf16; fp32 reads the forward's activations), a third time, less the
    two outputs the recompute skips as nothing reads them (the rgb layer,
    W/2 x 3, and the alpha column, W x 1)."""
    W = cfg.netwidth
    macs = macs_per_point(cfg, head)
    return 2 * (2 * macs + (macs - 3 * (W // 2) - W if recompute else 0))


def _bwd_acts_bytes(p, n: int) -> int:
    """Bytes of the fp32 forward's activations an fp32 backward reads (0
    in bf16, which recomputes them)."""
    from plnerf_torch.kernels import fused_mlp

    return n * fused_mlp.acts_cols(p) * 4 if p.dtype == torch.float32 else 0


def bwd_bound(p, x, v, g, n: int, cfg) -> tuple:
    """(bound_ms, bound_by) of one backward call: x, v, g, the fp32
    forward's activations and the packed weights read once, dx, dv and
    every fp32 grad written once, against ``bwd_flops_per_point`` at the
    card's peak for the operand type."""
    wbuf, bbuf = p.flat()
    n_grad = wbuf.numel() + bbuf.numel()
    nbytes = sum(t.numel() * t.element_size() for t in (x, v, g, wbuf, bbuf))
    nbytes += n * (p.in_p + p.v_p) * 4 + n_grad * 4 + _bwd_acts_bytes(p, n)
    flops = float(bwd_flops_per_point(
        cfg, p.head, p.dtype == torch.bfloat16)) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[p.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bwd_byte_floor(p, x, v, g, n: int) -> float:
    """ms the backward's own workspace traffic takes at the card's memory
    rate: its workspace (the bf16 acts and dacts images or the fp32
    transposed weights and activation grads, and the partial grads)
    written once and read once, beside x, v, g, the fp32 forward's
    activations and the weights read once and dx, dv and the grads
    written once."""
    from plnerf_torch.kernels import fused_mlp

    lib = fused_mlp._bwd_library()
    bf16 = int(p.dtype == torch.bfloat16)
    ws = lib.plnerf_fused_mlp_bwd_workspace(
        n, p.n_layers, p.skip_mask, p.in_p, p.w_p, p.v_p, p.h_p, p.head, bf16)
    wbuf, bbuf = p.flat()
    n_grad = wbuf.numel() + bbuf.numel()
    nbytes = 2 * ws + sum(t.numel() * t.element_size()
                          for t in (x, v, g, wbuf, bbuf))
    nbytes += n * (p.in_p + p.v_p) * 4 + n_grad * 4 + _bwd_acts_bytes(p, n)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _kernel_name(demangled: str) -> str:
    """A backward kernel's short name from its demangled signature, the
    bf16 and fp32 weight kernels told apart by their job type."""
    m = re.search(r"::(\w+)[<(]", demangled)
    name = m.group(1) if m else demangled
    job = re.search(r"::(W?Jobs)\b", demangled)
    return f"{name}({job.group(1)})" if job else name


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| (fp64 sums)."""
    d = float((got.double() - ref.double()).norm())
    return d / max(float(ref.double().norm()), 1e-30)


def _bwd_hold(key, p, x, v, v_div, g, errs, rels, acts=None) -> None:
    """The backward kernel, called twice, against its plain version on the
    same inputs, in fp32 as training calls it: from the activations its
    forward kept, ``acts`` or, where none are given, those of a
    ``forward_cuda`` run here first.  The two calls must be bit-identical,
    and every dW and db block, dx and dv within BWD_TOLERANCE in relative
    L2 norm.  Not in max abs error: every grad jumps where a relu mask
    flips, and over 10^5 points x 2,048 units some pre-activation always
    lies within rounding of 0, kept by one summation order and dropped by
    another.  In fp32 the plain version summed in float64 shows how far
    the plain fp32 version itself sits from it (``rels[...
    _plain_vs_f64]``) beside the kernel (``_kernel_vs_f64``).  ``errs`` records max abs errors, ``rels``
    relative L2 errors, worst block of each output."""
    from plnerf_torch.kernels import fused_mlp

    if p.dtype == torch.float32 and acts is None:
        acts = x.new_empty((x.shape[0], fused_mlp.acts_cols(p)))
        fused_mlp.forward_cuda(p, x, v, v_div, acts)
    got = fused_mlp.backward_cuda(p, x, v, v_div, g, acts)
    again = fused_mlp.backward_cuda(p, x, v, v_div, g, acts)
    torch.cuda.synchronize()
    ref = fused_mlp.backward_plain(p, x, v, v_div, g)
    f64 = (fused_mlp.backward_plain(p, x, v, v_div, g, torch.float64)
           if p.dtype == torch.float32 else None)
    tol = BWD_TOLERANCE[p.dtype]
    for o, name in enumerate(("dW", "db", "dx", "dv")):
        blocks = [got[o], again[o], ref[o]] + ([f64[o]] if f64 else [])
        if not isinstance(got[o], list):
            blocks = [[b] for b in blocks]
        k = f"{key}_{name}"
        for i, (ga, gb, gr, *g64) in enumerate(zip(*blocks)):
            where = f"backward {key} {name}[{i}]"
            if not torch.equal(ga, gb):
                raise AssertionError(f"{where}: two calls on the same inputs "
                                     "differ")
            if not torch.isfinite(ga).all():
                raise AssertionError(f"{where}: non-finite")
            errs[k] = max(errs.get(k, 0.0), float((ga - gr).abs().max()))
            rels[k] = max(rels.get(k, 0.0), rel_l2(ga, gr))
            if g64:
                for tag, t in (("kernel", ga), ("plain", gr)):
                    kk = f"{k}_{tag}_vs_f64"
                    rels[kk] = max(rels.get(kk, 0.0), rel_l2(t, g64[0]))
            if rels[k] > tol:
                raise AssertionError(f"{where}: relative L2 error {rels[k]} "
                                     f"> {tol}")


def _bwd_pass_ms(fn, dev, reps: int = 3) -> dict:
    """Device ms per call of the backward's passes (data, weight, reduce;
    ``other``: the wrapper's own ops) from a short torch.profiler window
    of ``reps`` calls after one warm-up."""
    from plnerf_torch.utils.profile import profile_steps

    fn()
    prof = profile_steps(fn, reps, dev)
    return {**prof["ms_per_step"], "device": prof["device_ms_per_step"]}


def phase_bwd_kernel(dev):
    """Returns (max abs error over every comparison, times by schedule)."""
    from plnerf_torch.core.config import ModelConfig
    from plnerf_torch.core.mlp import apply_mlp
    from plnerf_torch.kernels import build, fused_mlp

    full = ModelConfig()
    dtypes = (torch.float32, torch.bfloat16)
    errs, rels = {}, {}
    S = N_COARSE + N_FINE
    with torch.no_grad():
        for tag, R, spr in (("65537", 1, 65537), ("coarse", N_RAND, N_COARSE),
                            ("fine", N_RAND, S)):
            for fold in (False, True):
                for dtype in dtypes:
                    _, _, _, p, x, v, v_div = _kernel_inputs(
                        full, R, spr, fold, dtype, dev, seed=4)
                    g = torch.randn(x.shape[0], 4, device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(5))
                    head = "folded" if fold else "split"
                    _bwd_hold(f"{head}_{str(dtype)[6:]}_{tag}", p, x, v,
                              v_div, g, errs, rels)
                    del p, x, v, g
        log("bwd_kernel_check", max_abs_err=errs, rel_l2_err=rels,
            tolerance={"float32": BWD_TOLERANCE[torch.float32],
                       "bfloat16": BWD_TOLERANCE[torch.bfloat16]},
            note="tolerance on the relative L2 error of every dW / db "
                 "block, dx and dv; every call repeated and bit-identical")

    # one fine pass of a 1024-ray step: 196,608 points
    n = N_RAND * S
    times = {}
    for dtype in dtypes:
        library_ms = None
        for fold in (False, True):
            m, pe, ve, p, x, v, v_div = _kernel_inputs(
                full, N_RAND, S, fold, dtype, dev, seed=6)
            g = torch.randn(n, 4, device=dev, generator=torch.Generator(
                device=dev).manual_seed(7))
            # fp32 as training runs it: from the activations its forward
            # kept (the standalone call, recompute_ms, runs that forward
            # first); bf16 recomputes them on chip
            acts = None
            if dtype == torch.float32:
                acts = x.new_empty((n, fused_mlp.acts_cols(p)))
                fused_mlp.forward_cuda(p, x, v, v_div, acts)
            entry = {"kernel_ms": cuda_ms(
                lambda: fused_mlp.backward_cuda(p, x, v, v_div, g, acts))}
            if acts is not None:
                entry["recompute_ms"] = cuda_ms(
                    lambda: fused_mlp.backward_cuda(p, x, v, v_div, g))
            entry["pass_ms"] = _bwd_pass_ms(
                lambda: fused_mlp.backward_cuda(p, x, v, v_div, g, acts),
                dev)
            entry["bound_ms"], entry["bound_by"] = bwd_bound(p, x, v, g, n,
                                                             full)
            entry["share_of_bound"] = entry["bound_ms"] / entry["kernel_ms"]
            entry["byte_floor_ms"] = bwd_byte_floor(p, x, v, g, n)
            entry["plain_ms"] = cuda_ms(
                lambda: fused_mlp.backward_plain(p, x, v, v_div, g), 3)
            if library_ms is None:
                # one PyTorch call for the same function: autograd through
                # the unfused MLP (cuBLAS), forward included (as in bf16's
                # kernel_ms and fp32's recompute_ms)
                params = list(m.parameters())
                pe_ = pe.detach().requires_grad_()
                ve_ = ve.detach().requires_grad_()
                cot = g.reshape(N_RAND, S, 4)

                def library():
                    with torch.enable_grad():
                        raw = apply_mlp(m, pe_, ve_, full, dtype)
                        return torch.autograd.grad(
                            raw, [pe_, ve_] + params, cot)

                library_ms = cuda_ms(library, 3)
            entry["library_ms"] = library_ms
            times[f"{'folded' if fold else 'split'}_{str(dtype)[6:]}"] = entry
            del m, pe, ve, p, x, v, g, acts
            torch.cuda.empty_cache()
    ptxas = build.ptxas_info(fused_mlp.BWD_KERNEL) or {}
    log("bwd_kernel_time", points=n, rays=N_RAND, samples=S,
        card=card_line(), flops_per_point={
            str(dtype)[6:]: {
                "split": bwd_flops_per_point(full, fused_mlp.SPLIT, bf),
                "folded": bwd_flops_per_point(full, fused_mlp.FOLDED, bf)}
            for dtype, bf in zip(dtypes, (False, True))},
        times=times, parent_ms={"split_bfloat16": 5.91,
                                "folded_bfloat16": 5.36},
        registers={_kernel_name(k): {
            f: v[f] for f in ("registers", "spill_stores", "spill_loads",
                              "stack") if f in v}
            for k, v in ptxas.items() if "data_kernel" in k
            or "weight_kernel" in k},
        note="kernel_ms, pass_ms: fp32 from the forward's activations, "
             "as training calls it; recompute_ms: the fp32 call without "
             "them, which runs the forward first; pass_ms: device ms per "
             "call by pass; share_of_bound: bound_ms / kernel_ms; "
             "byte_floor_ms: the workspace written and read once at 3.35 "
             "TB/s (bwd_byte_floor); parent_ms: the "
             "bf16 times before the wgmma redesign (PERF.md, PR 17)")
    return max(errs.values()), times


def _train_setups(perturb=True, mlp_dtype="float32"):
    """(linear, constant-quadrature) setups of the blender_linear recipe,
    fused MLP on with folded heads."""
    import dataclasses

    from plnerf_torch.core.config import ModelConfig, RenderConfig
    from plnerf_torch.train.step import TrainSetup

    rcfg = RenderConfig(n_samples=N_COARSE, n_importance=N_FINE,
                        mode="linear", color_mode="midpoint",
                        white_bkgd=True, perturb=perturb,
                        mlp_dtype=mlp_dtype, use_fused_mlp=True,
                        fused_fold_heads=True)
    lin = TrainSetup(mcfg=ModelConfig(), rcfg=rcfg, lrate=5e-4,
                     coarse_lrate=5e-4, lrate_decay=500)
    const = dataclasses.replace(
        lin, rcfg=dataclasses.replace(rcfg, constant_init=True))
    return lin, const


def _sphere_scene(dev):
    from plnerf_torch.data.synthetic import make_sphere_dataset

    images, poses, hwf, K = make_sphere_dataset(8, 200, 200)
    return (torch.as_tensor(images, device=dev),
            torch.as_tensor(poses, device=dev), K,
            torch.arange(8, device=dev))


def _profile_steps(step, state, batches, dev) -> dict:
    """Device time by kernel over a few train steps (torch.profiler, read
    by plnerf_torch.utils.profile): ms per step in the forward kernel, the
    backward kernel's three passes and everything else, the device's busy
    share of the wall time and the top device and host ops."""
    from plnerf_torch.utils.profile import profile_steps

    it = iter(batches)

    def run():
        nonlocal state
        rays, target = next(it)
        state, _ = step(state, {"rays": rays, "target": target})

    return profile_steps(run, len(batches), dev)


def phase_train(dev, keep=None):
    """Returns (forward launches, backward launches, timing summary);
    ``keep["state"]`` is the final train state."""
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import batching
    from plnerf_torch.train.step import init_state, make_train_step

    images, poses, K, i_train = _sphere_scene(dev)
    lin, const = _train_setups()
    bf16, _ = _train_setups(mlp_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, lin, dev)
    steps = {"lin": make_train_step(lin), "const": make_train_step(const),
             "bf16": make_train_step(bf16)}
    torch.cuda.synchronize()

    fused_mlp.launches = fused_mlp.bwd_launches = 0   # main path starts
    rec = []
    for i in range(TRAIN_STEPS + BF16_STEPS):
        variant = ("bf16" if i >= TRAIN_STEPS else
                   "const" if i < CONSTANT_STEPS else "lin")
        precrop = i < PRECROP_STEPS
        f0, b0 = fused_mlp.launches, fused_mlp.bwd_launches
        s0 = fused_mlp.bwd_saved
        t0 = time.perf_counter()
        rays, target, _ = batching.sample_one_image_batch(
            images, poses, K, i_train, g, N_RAND, 2.0, 6.0, True,
            precrop=precrop, precrop_frac=0.5)
        state, m = steps[variant](state, {"rays": rays, "target": target})
        loss = float(m["loss"])                     # synchronises
        dt = time.perf_counter() - t0
        launches = (fused_mlp.launches - f0, fused_mlp.bwd_launches - b0)
        if launches != (2, 2):
            raise AssertionError(f"step {i}: {launches} forward / backward "
                                 "launches, expected 2 / 2 (coarse, fine)")
        # fp32 backwards read the activations their forward kept; bf16's
        # recompute on chip
        saved = fused_mlp.bwd_saved - s0
        if saved != (0 if variant == "bf16" else 2):
            raise AssertionError(f"step {i} ({variant}): {saved} backward "
                                 "calls read saved activations")
        if not np.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss}")
        rec.append({"variant": variant + ("_precrop" if precrop else ""),
                    "loss": loss, "psnr": float(m["psnr"]), "s": dt})
    fwd, bwd = fused_mlp.launches, fused_mlp.bwd_launches   # main path ends
    profile = _profile_steps(steps["lin"], state, [
        batching.sample_one_image_batch(images, poses, K, i_train, g, N_RAND,
                                        2.0, 6.0, True)[:2]
        for _ in range(3)], dev)

    profile_bf16 = _profile_steps(steps["bf16"], state, [
        batching.sample_one_image_batch(images, poses, K, i_train, g, N_RAND,
                                        2.0, 6.0, True)[:2]
        for _ in range(3)], dev)

    for prof in (profile, profile_bf16):
        bwd_ms = sum(prof["ms_per_step"][k] for k in (
            "fused_mlp_bwd_data", "fused_mlp_bwd_weight",
            "fused_mlp_bwd_reduce"))
        prof["bwd_share_of_device"] = bwd_ms / prof["device_ms_per_step"]
    fp32 = rec[:TRAIN_STEPS]
    first = statistics.mean(r["loss"] for r in fp32[:10])
    last = statistics.mean(r["loss"] for r in fp32[-10:])
    if not last < first:
        raise AssertionError(f"fp32 loss did not fall: first 10 steps "
                             f"{first}, last 10 {last}")

    def median_ms(rs):
        return statistics.median(r["s"] for r in rs) * 1e3

    by_variant = {}
    for r in rec[3:]:                                    # warm steps
        by_variant.setdefault(r["variant"], []).append(r)
    summary = {"ms_per_step_fp32": median_ms(fp32[3:]),
               "ms_per_step_bf16": median_ms(rec[TRAIN_STEPS + 3:]),
               "ms_per_step_by_variant": {k: median_ms(v)
                                          for k, v in by_variant.items()}}
    summary["train_rays_per_s_fp32"] = N_RAND / summary[
        "ms_per_step_fp32"] * 1e3
    summary["train_rays_per_s_bf16"] = N_RAND / summary[
        "ms_per_step_bf16"] * 1e3
    log("train", card=card_line(), rays_per_step=N_RAND,
        points_per_step={"coarse": N_RAND * N_COARSE,
                         "fine": N_RAND * (N_COARSE + N_FINE)},
        steps=len(rec), launches={"fused_mlp_fwd": fwd, "fused_mlp_bwd": bwd},
        launches_per_step={"fused_mlp_fwd": fwd / len(rec),
                           "fused_mlp_bwd": bwd / len(rec)},
        loss_first10_fp32=first, loss_last10_fp32=last,
        loss_last_bf16=rec[-1]["loss"], psnr_last_fp32=fp32[-1]["psnr"],
        **summary, profile_3_fp32_steps=profile,
        profile_3_bf16_steps=profile_bf16,
        bf16_backward_ms_per_step={
            "data": profile_bf16["ms_per_step"]["fused_mlp_bwd_data"],
            "weight": profile_bf16["ms_per_step"]["fused_mlp_bwd_weight"],
            "pr11": PR11_BF16_BWD_MS},
        losses=[round(r["loss"], 6) for r in rec])
    if keep is not None:
        keep["state"] = state
    return fwd, bwd, summary


def _grads(state) -> dict:
    return {f"{n}.{k}": q.grad.detach().cpu().clone()
            for n, model in (("c", state.params_coarse),
                             ("f", state.params_fine))
            for k, q in model.named_parameters()}


def _grad_errs(got: dict, ref: dict) -> dict:
    """Relative L2 error per tensor, and over all of them (``all``)."""
    errs = {k: rel_l2(got[k], r) for k, r in ref.items()}
    names = sorted(ref)
    errs["all"] = rel_l2(torch.cat([got[k].reshape(-1) for k in names]),
                         torch.cat([ref[k].reshape(-1) for k in names]))
    return errs


def phase_train_reference(dev):
    """Three steps from the same weights on the same injected batch on the
    card (kernels) and on the CPU (plain versions): step-1 grads to 1e-3
    relative L2 over both networks and 1e-2 per tensor, losses to 1e-3
    relative.  The two devices round the encoding, the quadrature and
    every sum differently; a tensor whose grad is nearly 0 (at step 1 the
    coarse colour head's) shows that most.  So the card's first step also
    runs with the unfused MLP (autograd through ``apply_mlp``, cuBLAS) on
    the same device, and the kernels must match it to 1e-4 over all and
    1e-3 per tensor (relu mask flips, see _bwd_hold)."""
    import dataclasses

    from plnerf_torch.train import batching
    from plnerf_torch.train.step import (_render_loss, init_state,
                                         make_train_step)

    images, poses, K, i_train = _sphere_scene("cpu")
    lin, _ = _train_setups(perturb=False)
    unfused = dataclasses.replace(lin, rcfg=dataclasses.replace(
        lin.rcfg, use_fused_mlp=False, fused_fold_heads=False))
    rng = np.random.default_rng(3)
    rays, target, _ = batching.sample_one_image_batch(
        images, poses, K, i_train, None, 256, 2.0, 6.0, True,
        draws=(rng.integers(0, len(i_train)),
               rng.integers(0, images.shape[1], 256),
               rng.integers(0, images.shape[2], 256)))
    card = init_state(torch.Generator(device=dev).manual_seed(1), lin, dev)
    host = init_state(None, lin, "cpu")
    host.params_coarse.load_state_dict(card.params_coarse.state_dict())
    host.params_fine.load_state_dict(card.params_fine.state_dict())
    loss, _ = _render_loss(card.params_coarse, card.params_fine,
                           {"rays": rays.to(dev), "target": target.to(dev)},
                           None, unfused)
    loss.backward()
    unfused_grads = _grads(card)
    runs = {}
    for name, state in (("card", card), ("cpu", host)):
        d = next(state.params_coarse.parameters()).device
        step = make_train_step(lin)
        batch = {"rays": rays.to(d), "target": target.to(d)}
        losses, grads = [], None
        for i in range(3):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = _grads(state)
        runs[name] = {"losses": losses, "grads": grads}
    gpu, cpu = runs["card"], runs["cpu"]
    vs_cpu = _grad_errs(gpu["grads"], cpu["grads"])
    vs_unfused = _grad_errs(gpu["grads"], unfused_grads)
    loss_err = [abs(a / b - 1) for a, b in zip(gpu["losses"],
                                               cpu["losses"])]
    log("train_reference", rays=256, steps=3, losses_card=gpu["losses"],
        losses_cpu=cpu["losses"], loss_rel_err=loss_err,
        grad_rel_l2_err_card_vs_cpu=vs_cpu,
        grad_rel_l2_err_kernels_vs_unfused_on_card=vs_unfused,
        tolerance={"card_vs_cpu": "1e-3 over all, 1e-2 per tensor",
                   "kernels_vs_unfused": "1e-4 over all, 1e-3 per tensor",
                   "loss": "1e-3 relative"})
    for what, errs, lim in (("card vs CPU", vs_cpu, 1e-3),
                            ("kernels vs unfused", vs_unfused, 1e-4)):
        worst = max((k for k in errs if k != "all"), key=errs.get)
        if not (errs["all"] <= lim and errs[worst] <= 10 * lim):
            raise AssertionError(f"step-1 grads {what}: relative L2 error "
                                 f"{errs['all']} over all, {errs[worst]} "
                                 f"in {worst}")
    if not max(loss_err) <= 1e-3:
        raise AssertionError(f"losses card {gpu['losses']} CPU "
                             f"{cpu['losses']}")


def _records(exp: str, key: str) -> dict:
    """{step: record} of the metrics.jsonl records holding ``key``."""
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if key in r}


def _driver_view(argv, state, stride: int = 8, hyp: bool = False,
                 frame=None) -> dict:
    """One test view of ``state`` (with ``frame``, that frame of the
    camera path at ``--render_factor``) through the driver's eval configs
    with ``--eval_det``: rendered whole on the card (the kernel on), and at
    every ``stride``-th pixel of each axis on the CPU with the same weights
    (the kernel's plain version); the two held to ``REFERENCE_TOL`` (with
    ``hyp``, ``pred_hyp`` too, at ``HYP_TOL``).  NDC rays for LLFF."""
    import copy
    import dataclasses

    from plnerf_torch.cli import config, run_plnerf
    from plnerf_torch.cli.datasets import load_dataset
    from plnerf_torch.core import rays as raysmod
    from plnerf_torch.core.render import make_ray_batch
    from plnerf_torch.eval import images as EI
    from plnerf_torch.eval import metrics as Mx

    args = config.resolve_args(config.config_parser().parse_args(
        argv + ["--eval_det"]))
    mcfg, rcfg, setup = run_plnerf.build_configs(args)
    rcfg = run_plnerf.eval_render_config(args, rcfg)
    if rcfg.perturb or not rcfg.use_fused_mlp:
        raise AssertionError(f"eval config {rcfg}")
    rcfg = dataclasses.replace(rcfg, compute_pred_hyp=hyp)
    tol = HYP_TOL if hyp else REFERENCE_TOL
    bundle = load_dataset(args)
    data, vi = bundle.data, int(bundle.i_test[0])
    pose, factor = data.poses[vi], 0
    if frame is not None:
        pose, factor = data.render_poses[frame], args.render_factor
    t = time.perf_counter()
    card = EI.render_image(state.params_coarse, state.params_fine,
                           pose, data.hwf, data.K, mcfg, rcfg,
                           near=bundle.near, far=bundle.far,
                           chunk=args.chunk, ndc=bundle.ndc,
                           mcfg_fine=setup.mcfg_fine, keep_hyp=hyp,
                           render_factor=factor)
    card_s = time.perf_counter() - t
    H, W = card["rgb_map"].shape[:2]
    focal = float(data.hwf[2]) / (factor or 1)
    K = (np.asarray(data.K) if not factor else np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32))
    c2w = torch.as_tensor(np.asarray(pose, np.float32)[:3, :4])
    ro, rd = raysmod.get_rays(H, W, K, c2w)
    packed, _ = make_ray_batch(ro, rd, bundle.near, bundle.far,
                               rcfg.use_viewdirs, bundle.ndc, H, W, focal)
    rays = packed.reshape(H, W, -1)[::stride, ::stride]
    t = time.perf_counter()
    cpu = EI.render_chunks(
        copy.deepcopy(state.params_coarse).to("cpu"),
        copy.deepcopy(state.params_fine).to("cpu"),
        rays.reshape(-1, rays.shape[-1]), mcfg, rcfg, 4096, 0,
        tuple(REFERENCE_TOL), mcfg_fine=setup.mcfg_fine, keep_hyp=hyp)
    cpu_s = time.perf_counter() - t
    n = rays.shape[0] * rays.shape[1]
    cpu = {k: v.numpy().reshape(n, -1) for k, v in cpu.items()}
    sub = {k: card[k][::stride, ::stride].reshape(n, -1) for k in tol}
    out = {"view": vi if frame is None else f"render_poses[{frame}]",
           "card_pixels": H * W, "cpu_pixels": n,
           "max_abs_err": _card_vs_cpu(sub, cpu, tol), "tolerance": tol,
           "card_s": card_s, "cpu_s": cpu_s}
    if frame is None:
        gt = np.asarray(data.images[vi])
        out["psnr_card"] = Mx.mse2psnr(float(np.mean(
            (card["rgb_map"] - gt) ** 2)))
        out["psnr0_card"] = Mx.mse2psnr(float(np.mean(
            (card["rgb0"] - gt) ** 2)))
    return out


# {run name: {"captures", "replays", "capture_s", "eager_steps"}}: the CUDA
# graphs of each ``_driver_runs`` run's windows (``train/graph.py``) and
# the steps its windows ran eagerly, whose launches the wrappers count
GRAPH_RUNS = {}


def _driver_runs(entry=None):
    """(run, expect, launches, runs): ``run(name, argv)`` calls the driver's
    entry point (``run_plnerf.main`` unless ``entry`` is given), the
    kernels' launch counters set to 0 just before and read just after into
    ``launches[name]`` (the wrappers count what they launch: a graph's
    replays launch nothing from Python, and ``phase_dispatch`` counts
    their kernels in traces), its seconds into ``runs[name]``, its
    graphs' captures and replays and the steps of the windows it ran
    eagerly into ``GRAPH_RUNS[name]``; ``expect(name, fwd, bwd)`` holds
    a run's launches."""
    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import graph

    entry = entry or run_plnerf.main

    launches, runs = {}, {}

    def run(name, argv):
        made, orig = [], graph.Graphs

        class Seen(orig):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        torch.cuda.synchronize()
        fused_mlp.launches = fused_mlp.bwd_launches = 0   # path starts
        graph.Graphs = Seen
        t = time.perf_counter()
        try:
            out = entry(argv)
        finally:
            graph.Graphs = orig
        torch.cuda.synchronize()
        runs[name] = time.perf_counter() - t
        launches[name] = {"fused_mlp_fwd": fused_mlp.launches,  # ends
                          "fused_mlp_bwd": fused_mlp.bwd_launches}
        GRAPH_RUNS[name] = {k: sum(getattr(g, k) for g in made)
                            for k in ("captures", "replays", "capture_s")}
        GRAPH_RUNS[name]["eager_steps"] = sum(
            n for g in made for _, n, kind in g.windows()
            if kind not in graph.STAGED)
        GRAPH_RUNS[name]["windows"] = _window_kinds(made)
        return out

    def expect(name, fwd, bwd):
        got = launches[name]
        if (got["fused_mlp_fwd"], got["fused_mlp_bwd"]) != (fwd, bwd):
            raise AssertionError(f"driver {name}: launches {got}, "
                                 f"expected {fwd} / {bwd}")

    return run, expect, launches, runs


def _window_kinds(made) -> list:
    """The kind of every window the ``graph.Graphs`` of ``made`` ran, in
    order ("first", "capture", "replay" or "eager")."""
    return [kind for g in made for _, _, kind in g.windows()]


class _Recording:
    """Wraps ``module.name`` while active: each call's seconds and
    result go to ``calls``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.calls.append((time.perf_counter() - t, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def sphere_data(scenes: str) -> tuple:
    """(data_dir, seconds): ``scenes``, holding the driver phases' sphere
    scene ``sphere`` (``DRIVER_VIEWS`` at ``DRIVER_SIZE``), written unless
    it is there already (then 0 s)."""
    from plnerf_torch.data.synthetic import write_sphere_scene

    path = os.path.join(scenes, "sphere")
    if os.path.isdir(path):
        return scenes, 0.0
    t0 = time.perf_counter()
    write_sphere_scene(path, DRIVER_SIZE, DRIVER_VIEWS)
    return scenes, time.perf_counter() - t0


def phase_driver(dev, bare_step_ms=None, scenes=None, keep=None):
    """Returns (forward launches, backward launches) of the driver's runs.
    ``scenes``: where the sphere scene is or goes (``sphere_data``);
    ``keep``: a directory for the runs' checkpoints (``keep/ckpt/smoke``,
    left for the video and mesh phases), else a temporary one."""
    import shutil
    import tempfile

    from plnerf_torch.checkpoint import io as ckio
    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.data.synthetic import write_fixed_dist_scene

    t_phase = time.perf_counter()
    root = keep or tempfile.mkdtemp(prefix="plnerf_driver_")
    try:
        ckpt = os.path.join(root, "ckpt")
        data, scene_s = sphere_data(scenes or os.path.join(root, "data"))
        t0 = time.perf_counter()
        write_fixed_dist_scene(os.path.join(data, "fixdist"), DRIVER_SIZE,
                               run_plnerf.FIXED_DIST_NEAR, FIXED_DIST_VIEWS)
        fixed_scene_s = time.perf_counter() - t0
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "blender_linear.txt")
        where = ["--ckpt_dir", ckpt, "--expname", "smoke", "--data_dir", data,
                 "--scene_id", "sphere"]
        exp = os.path.join(ckpt, "smoke")
        eval_chunks = -(-DRIVER_SIZE * DRIVER_SIZE // R_CHUNK)
        run, expect, launches, runs = _driver_runs()

        train = ["--config", config, "--task", "train"] + where + DRIVER_TRAIN
        state = run("train", train + ["--num_iterations", str(DRIVER_STEPS)])
        # two val renders (i_img at 150, 300), two launches per chunk each
        expect("train", 2 * DRIVER_STEPS + 2 * 2 * eval_chunks,
               2 * DRIVER_STEPS)
        # --profile: steps 304-308 of the resumed run traced
        state = run("resume", train + ["--num_iterations",
                                       str(DRIVER_RESUME_STEPS),
                                       "--profile", str(DRIVER_PROFILE)])
        resumed = DRIVER_RESUME_STEPS - DRIVER_STEPS
        expect("resume", 2 * resumed, 2 * resumed)      # started at 300
        profile = _profile_trace(os.path.join(
            exp, "profile", f"trace_{DRIVER_STEPS + 4:06d}.json"),
            DRIVER_PROFILE)
        ckpts = [os.path.basename(p) for p in ckio.list_checkpoints(exp)]
        if state.step != DRIVER_RESUME_STEPS or ckpts != [
                "000150.ckpt", "000300.ckpt", "000400.ckpt"]:
            raise AssertionError(f"step {state.step}, checkpoints {ckpts}")
        recs = _records(exp, "train/loss")
        losses = {k: r["train/loss"] for k, r in recs.items()}
        if not (np.isfinite(list(losses.values())).all()
                and losses[DRIVER_RESUME_STEPS] < losses[50]):
            raise AssertionError(f"loss did not fall: {losses}")

        test = ["--task", "test", "--white_bkgd"] + where
        n_test = DRIVER_VIEWS["test"]
        scores = {}
        lp_path = write_lpips_weights(os.path.join(root, "lpips_alex.npz"))
        lp_flag = ["--lpips_weights", lp_path]
        for name, extra in (("test", lp_flag),
                            ("test_init", ["--no_reload"])):
            with _Recording(run_plnerf.EI,
                            "render_images_with_metrics") as rec:
                mm = run(name, test + extra)
            expect(name, 2 * n_test * eval_chunks, 0)
            result_dir, = [d for d in os.listdir(exp)
                           if d.startswith("test_images_")]
            metrics_txt = os.path.join(exp, result_dir, "metrics.txt")
            with open(metrics_txt) as f:
                text = f.read()
            if "psnr: " not in text or "ssim: " not in text:
                raise AssertionError(f"metrics.txt: {text!r}")
            scores[name] = {k: mm.as_dict().get(k)
                            for k in ("psnr", "ssim", "lpips")}
            if name == "test":
                lpips = _lpips_hold(dev, lp_path, rec.calls[0][1][1],
                                    _lpips_row(metrics_txt))
        if not scores["test"]["psnr"] > scores["test_init"]["psnr"]:
            raise AssertionError(f"held-out PSNR {scores}")
        view = _driver_view(test, state)

        # the fixed-distance sweep from the step-400 checkpoint
        with _Recording(run_plnerf.EI, "render_images_with_metrics") as rec:
            sweep = run("test_fixed_dist", test[2:] + lp_flag + [
                "--task", "test_fixed_dist", "--eval_data_dir", data,
                "--eval_scene_id", "fixdist"])
        n_dist = len(run_plnerf.FIXED_DIST_NEAR)
        expect("test_fixed_dist", 2 * n_dist * FIXED_DIST_VIEWS
               * eval_chunks, 0)
        fixed = {}
        for (d, mm), (s_, _) in zip(sweep.items(), rec.calls):
            sub = os.path.join(exp, f"test_images_dist{d}_sphere")
            with open(os.path.join(sub, "metrics.txt")) as f:
                if "psnr: " not in f.read():
                    raise AssertionError(f"{sub}/metrics.txt")
            fixed[d] = {"near": run_plnerf.FIXED_DIST_NEAR[d],
                        "psnr": mm.get("psnr"), "ssim": mm.get("ssim"),
                        "lpips": _lpips_row(os.path.join(sub,
                                                         "metrics.txt")),
                        "s_per_image": s_ / FIXED_DIST_VIEWS}
        if len(fixed) != n_dist or len(rec.calls) != n_dist:
            raise AssertionError(f"fixed-dist results {fixed}")

        # checkpoint save and load of the step-400 state, on their own
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = ckio.save_checkpoint(os.path.join(root, "timed"), state.step,
                                    state.state_dict())
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        ckio.restore_checkpoint(path, state, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t

        # each i_print window's time: its steps over its steps_per_sec
        window_s = {k: DRIVER_PRINT / r["train/steps_per_sec"]
                    for k, r in recs.items()}
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        log("driver", card=card_line(), scene={
            "views": DRIVER_VIEWS, "size": DRIVER_SIZE, "write_s": scene_s,
            "fixed_dist_write_s": fixed_scene_s},
            config="configs/blender_linear.txt", steps=DRIVER_RESUME_STEPS,
            resumed_from=DRIVER_STEPS, checkpoints=ckpts,
            train_loss=losses, train_psnr={k: r["train/psnr"]
                                           for k, r in recs.items()},
            val_psnr={k: r["val/psnr"]
                      for k, r in _records(exp, "val/psnr").items()},
            ms_per_step=1e3 * sum(window_s.values()) / DRIVER_RESUME_STEPS,
            ms_per_step_by_window={k: 1e3 * v / DRIVER_PRINT
                                   for k, v in window_s.items()},
            ms_per_step_wall=1e3 * (runs["train"] + runs["resume"])
            / DRIVER_RESUME_STEPS,
            bare_step_ms_train_phase=bare_step_ms,
            s_per_test_image=runs["test"] / n_test, run_s=runs,
            ckpt_save_s=save_s, ckpt_load_s=load_s,
            ckpt_bytes=os.path.getsize(path),
            psnr_init=scores["test_init"]["psnr"],
            ssim_init=scores["test_init"]["ssim"],
            psnr_400=scores["test"]["psnr"], ssim_400=scores["test"]["ssim"],
            lpips_400=scores["test"]["lpips"], lpips=lpips, profile=profile,
            view_check=view, fixed_dist=fixed,
            launches=launches, launches_per_train_step={
                "fused_mlp_fwd": 2.0, "fused_mlp_bwd": 2.0},
            phase_s=time.perf_counter() - t_phase,
            note="ms_per_step: the i_print windows' times, from "
                 "metrics.jsonl's steps_per_sec, summed over all 400 steps "
                 "(val renders and checkpoint saves included); "
                 "ms_per_step_wall: the train and resume calls' wall time "
                 "over the steps (scene load, init and the last save "
                 "too); s per test image: the test task's wall time "
                 "(scene and checkpoint load, renders, SSIM, png writes) "
                 "over its images; the resumed run traced steps "
                 f"{DRIVER_STEPS + 4}-{DRIVER_STEPS + 3 + DRIVER_PROFILE} "
                 "under --profile (their window's time includes the "
                 "profiler's); lpips: seeded random weights, so the "
                 "number checks the metric's path, not the model's "
                 "perceptual quality")
        return fwd, bwd
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


def write_lpips_weights(path: str, seed: int = 0) -> str:
    """Seeded random LPIPS weights in the exported ``.npz`` layout (HWIO
    convolutions, [C, 1] heads): the metric's path on the card with
    nothing downloaded.  Returns ``path``."""
    from plnerf_torch.eval.lpips import LPIPS

    sd = LPIPS.init_random(torch.Generator().manual_seed(seed)).state_dict()
    out = {}
    for i in range(5):
        out[f"conv{i}_w"] = sd[f"conv{i}_w"].permute(2, 3, 1, 0).numpy()
        out[f"conv{i}_b"] = sd[f"conv{i}_b"].numpy()
        out[f"lin{i}_w"] = sd[f"lin{i}_w"].reshape(1, -1).T.numpy()
    np.savez(path, **out)
    return path


def _lpips_row(metrics_txt: str) -> float:
    """The finite ``lpips`` row of a metrics.txt; raises otherwise."""
    with open(metrics_txt) as f:
        rows = dict(line.rstrip("\n").split(": ", 1) for line in f)
    value = float(rows.get("lpips", "nan"))
    if not np.isfinite(value):
        raise AssertionError(f"{metrics_txt}: lpips {rows.get('lpips')}")
    return value


def _lpips_hold(dev, path: str, res: dict, row: float) -> dict:
    """LPIPS of the test task's images on the card against the CPU's on
    the same arrays and weights (1e-5 relative), their mean against the
    driver's metrics.txt row, and seconds per image on the card at the
    images' size and at twice it (one pair upsampled)."""
    from plnerf_torch.eval.lpips import load_lpips

    card, cpu = load_lpips(path, dev), load_lpips(path, "cpu")
    pairs = list(zip(res["rgbs"], res["target_rgbs"]))
    got = [card(a, b) for a, b in pairs]
    ref = [cpu(a, b) for a, b in pairs]
    rel = max(abs(g - r) / abs(r) for g, r in zip(got, ref))
    if rel > LPIPS_TOL or abs(np.mean(got) - row) > LPIPS_TOL * abs(row):
        raise AssertionError(f"lpips card {got}, CPU {ref}, row {row}")

    def seconds(a, b, reps=3):
        card(a, b)                                  # warm
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            card(a, b)                              # float(): synced
            times.append(time.perf_counter() - t)
        return statistics.median(times)

    a, b = pairs[0]
    up = [np.repeat(np.repeat(x, 2, 0), 2, 1) for x in (a, b)]
    return {"card": got, "cpu": ref, "max_rel_err": rel,
            "tolerance": LPIPS_TOL, "metrics_txt": row,
            f"s_per_image_{a.shape[0]}x{a.shape[1]}": seconds(a, b),
            f"s_per_image_{up[0].shape[0]}x{up[0].shape[1]}":
                seconds(*up)}


def _profile_trace(path: str, steps: int) -> dict:
    """The --profile window's Chrome trace: its top device kernels by ms
    per step; raises unless it holds both fused MLP kernels."""
    from plnerf_torch.utils.profile import fused_group

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    ms = {}
    for e in events:
        ms[e["name"]] = ms.get(e["name"], 0.0) + e["dur"] / 1e3 / steps
    top = [[k[:80], v] for k, v in sorted(ms.items(),
                                         key=lambda kv: -kv[1])[:5]]
    groups = {fused_group(name) for name in ms}
    if not {"fused_mlp_fwd", "fused_mlp_bwd_data"} <= groups:
        raise AssertionError(f"{path}: kernels {sorted(ms)[:8]}")
    return {"trace": os.path.basename(path), "steps": steps,
            "kernels": len(ms), "top_device_ops_ms_per_step": top}


def phase_llff(dev):
    """Returns (forward launches, backward launches) of the LLFF runs."""
    import shutil
    import tempfile

    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.data.synthetic import make_llff_fixture

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plnerf_llff_")
    try:
        data, ckpt = os.path.join(root, "data"), os.path.join(root, "ckpt")
        H, W = LLFF_HW
        t0 = time.perf_counter()
        make_llff_fixture(os.path.join(data, "ff"), n=LLFF_VIEWS, H=H, W=W,
                          factor=LLFF_FACTOR, n_march=LLFF_MARCH,
                          workers=min(8, os.cpu_count() or 1))
        scene_s = time.perf_counter() - t0
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "llff_linear.txt")
        where = ["--ckpt_dir", ckpt, "--expname", "llff", "--data_dir", data,
                 "--scene_id", "ff", "--dataset", "llff"]
        exp = os.path.join(ckpt, "llff")
        eval_chunks = -(-H * W // R_CHUNK)
        i_test = list(range(0, LLFF_VIEWS, 8))
        n_train = LLFF_VIEWS - len(i_test)
        run, expect, launches, runs = _driver_runs()

        with _Recording(run_plnerf.batching, "build_ray_pool") as pool:
            state = run("train", ["--config", config, "--task", "train",
                                  "--num_iterations", str(LLFF_STEPS)]
                        + where + LLFF_TRAIN)
        # two val renders (i_img at 150, 300), two launches per chunk each
        expect("train", 2 * LLFF_STEPS + 2 * 2 * eval_chunks,
               2 * LLFF_STEPS)
        (pool_s, rows), = pool.calls
        if rows.shape != (n_train * H * W, 12):
            raise AssertionError(f"pool {rows.shape}")
        recs = _records(exp, "train/loss")
        losses = {k: r["train/loss"] for k, r in recs.items()}
        if not (np.isfinite(list(losses.values())).all()
                and losses[LLFF_STEPS] < losses[LLFF_PRINT]):
            raise AssertionError(f"loss did not fall: {losses}")

        test = ["--task", "test"] + where
        scores = {}
        for name, extra in (("test", []), ("test_init", ["--no_reload"])):
            mm = run(name, test + extra)
            expect(name, 2 * len(i_test) * eval_chunks, 0)
            scores[name] = {k: mm.get(k) for k in ("psnr", "ssim")}
        if not scores["test"]["psnr"] > scores["test_init"]["psnr"]:
            raise AssertionError(f"held-out PSNR {scores}")

        err = run("samples_error", ["--task", "test_samples_error",
                                    "--eval_det"] + where)
        expect("samples_error", 2 * len(i_test) * eval_chunks, 0)
        sub, = [d for d in os.listdir(exp)
                if d.startswith("test_samples_error_")]
        with open(os.path.join(exp, sub, "metrics_expecteddepth.txt")) as f:
            k, v = f.read().split(": ")
        if k != "importance_sampling_error" or not np.isfinite(float(v)):
            raise AssertionError(f"metrics_expecteddepth.txt: {k}: {v}")
        view = _driver_view(test, state, hyp=True)

        window_s = {k: LLFF_PRINT / r["train/steps_per_sec"]
                    for k, r in recs.items()}
        log("llff", card=card_line(), scene={
            "views": LLFF_VIEWS, "images": f"images_{LLFF_FACTOR}",
            "size": [H, W], "hwf_full": [H * LLFF_FACTOR, W * LLFF_FACTOR],
            "n_march": LLFF_MARCH, "write_s": scene_s},
            config="configs/llff_linear.txt", steps=LLFF_STEPS,
            i_test=i_test, pool={"rows": rows.shape[0],
                                 "columns": rows.shape[1],
                                 "bytes": rows.nbytes, "build_s": pool_s},
            train_loss=losses, train_psnr={k: r["train/psnr"]
                                           for k, r in recs.items()},
            val_psnr={k: r["val/psnr"]
                      for k, r in _records(exp, "val/psnr").items()},
            ms_per_step=1e3 * sum(window_s.values()) / LLFF_STEPS,
            ms_per_step_by_window={k: 1e3 * v / LLFF_PRINT
                                   for k, v in window_s.items()},
            s_per_test_image=runs["test"] / len(i_test),
            s_per_samples_error_image=runs["samples_error"] / len(i_test),
            run_s=runs, psnr_init=scores["test_init"]["psnr"],
            ssim_init=scores["test_init"]["ssim"],
            psnr=scores["test"]["psnr"], ssim=scores["test"]["ssim"],
            importance_sampling_error=err.get("importance_sampling_error"),
            view_check=view, launches=launches,
            launches_per_train_step={"fused_mlp_fwd": 2.0,
                                     "fused_mlp_bwd": 2.0},
            phase_s=time.perf_counter() - t_phase,
            note="ms_per_step: the i_print windows' times summed over the "
                 "run (val renders and checkpoints included); pool build_s: "
                 "build_ray_pool on the host (rays, shuffle, NDC warp); s "
                 "per test image: the task's wall time over its images")
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        return fwd, bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``, with its vendor,
    family, model number and clock (a virtual machine may report the name
    as "unknown"), and the core count."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                       # the first processor only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    ids = ", ".join(f"{k} {info[k]}" for k in (
        "vendor_id", "cpu family", "model", "cpu MHz") if k in info)
    name = info.get("model name", "not reported")
    return f"{name} ({ids or platform.machine()}), {os.cpu_count()} cores"


def phase_jpeg(dev):
    """Returns (forward launches, backward launches) of the LLFF runs from
    the JPEG capture."""
    import shutil
    import tempfile

    from plnerf_torch.cli import run_plnerf
    from plnerf_torch.data import jpeg, llff
    from plnerf_torch.data.png import read_png

    t_phase = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            JPEG_FIXTURES)
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    t0 = time.perf_counter()
    jpeg._load()
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    names = sorted(n for n in manifest if n.startswith("conformance/"))
    bad = [n for n in names if jpeg.digest(jpeg.read_jpeg(
        os.path.join(fixtures, n))) != manifest[n]["digest"]]
    if bad or not names:
        raise AssertionError(f"jpeg: {len(bad)} of {len(names)} conformance "
                             f"files differ from cv2's decode: {bad}")
    conformance_s = time.perf_counter() - t0

    big, = [n for n in manifest if n.startswith("big")]
    with open(os.path.join(fixtures, big), "rb") as f:
        buf = f.read()
    decodes = []
    for _ in range(JPEG_DECODES):
        stages = {}
        t0 = time.perf_counter()
        img = jpeg.decode_jpeg(buf, big, stages)
        decodes.append(dict(stages, total=time.perf_counter() - t0))
        if jpeg.digest(img) != manifest[big]["digest"]:
            raise AssertionError(f"jpeg: {big} differs from cv2's decode")
    med = {k: statistics.median(d[k] for d in decodes) for k in decodes[0]}
    mp = img.shape[0] * img.shape[1] / 1e6

    root = tempfile.mkdtemp(prefix="plnerf_jpeg_")
    try:
        data, ckpt = os.path.join(root, "data"), os.path.join(root, "ckpt")
        scene = os.path.join(data, "capture")
        shutil.copytree(os.path.join(fixtures, "capture"), scene)
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "llff_linear.txt")
        where = ["--ckpt_dir", ckpt, "--expname", "jpeg", "--data_dir", data,
                 "--scene_id", "capture", "--dataset", "llff",
                 "--factor", "2"]
        exp = os.path.join(ckpt, "jpeg")
        run, expect, launches, runs = _driver_runs()
        train = ["--config", config, "--task", "train"] + where + JPEG_TRAIN
        with _Recording(llff, "_minify") as minify, \
                _Recording(llff, "_read_rgb") as reads:
            run("train", train + ["--num_iterations", str(JPEG_STEPS),
                                  "--i_weights", str(JPEG_STEPS)])
        expect("train", 2 * JPEG_STEPS, 2 * JPEG_STEPS)
        run("resume", train + ["--num_iterations", str(JPEG_RESUME_STEPS),
                               "--i_weights", str(JPEG_RESUME_STEPS)])
        steps = JPEG_RESUME_STEPS - JPEG_STEPS
        expect("resume", 2 * steps, 2 * steps)
        (minify_s, _), = minify.calls[:1]
        jpeg_reads = [t for t, im in reads.calls if im.shape == (756, 1008, 3)]
        small_dir = os.path.join(scene, "images_2")
        views = sorted(n for n in manifest if n.startswith("capture/"))
        pngs = sorted(os.listdir(small_dir))
        if pngs != [os.path.basename(v)[:-4] + ".png" for v in views]:
            raise AssertionError(f"jpeg: images_2 holds {pngs}")
        for v, png_name in zip(views, pngs):
            small = read_png(os.path.join(small_dir, png_name))
            if small.shape != (378, 504, 3) or \
                    jpeg.digest(small) != manifest[v]["images_2_digest"]:
                raise AssertionError(f"jpeg: images_2/{png_name} "
                                     f"{small.shape} differs from its "
                                     "manifest digest")
        recs = _records(exp, "train/loss")
        losses = {k: r["train/loss"] for k, r in recs.items()}
        if not (np.isfinite(list(losses.values())).all()
                and losses[JPEG_RESUME_STEPS] < losses[JPEG_PRINT]):
            raise AssertionError(f"jpeg: loss did not fall: {losses}")
        mm = run("test", ["--task", "test"] + where)
        i_test = list(range(0, len(views), 8))
        expect("test", 2 * len(i_test) * -(-378 * 504 // R_CHUNK), 0)
        if not np.isfinite(mm.get("psnr")):
            raise AssertionError(f"jpeg: held-out PSNR {mm.get('psnr')}")
        window_s = {k: JPEG_PRINT / r["train/steps_per_sec"]
                    for k, r in recs.items()}
        log("jpeg", card=card_line(), cpu=cpu_model(), build_s=build_s,
            conformance={"files": len(names), "equal": len(names),
                         "s": conformance_s},
            decode={"file": big, "size": list(img.shape),
                    "bytes": len(buf), "decodes": JPEG_DECODES,
                    "s_per_image": med["total"],
                    "mp_per_s": mp / med["total"],
                    "stage_s": {k: med[k] for k in (
                        "parse", "entropy", "idct", "upsample", "color")},
                    "all_s": [d["total"] for d in decodes]},
            scene={"views": len(views), "source": [756, 1008],
                   "images_2": [378, 504], "i_test": i_test},
            minify_s=minify_s, minify_s_per_view=minify_s / len(views),
            jpeg_decode_s_per_view=statistics.median(jpeg_reads),
            config="configs/llff_linear.txt", steps=JPEG_RESUME_STEPS,
            train_loss=losses,
            ms_per_step=1e3 * sum(window_s.values()) / JPEG_RESUME_STEPS,
            ms_per_step_by_window={k: 1e3 * v / JPEG_PRINT
                                   for k, v in window_s.items()},
            run_s=runs, psnr=mm.get("psnr"), ssim=mm.get("ssim"),
            launches=launches, phase_s=time.perf_counter() - t_phase,
            note="decode: host seconds of decode_jpeg on the 12 MP file, "
                 "the median of the decodes; minify_s: llff._minify in the "
                 "first train run (20 JPEG decodes, area resizes and PNG "
                 "writes); ms_per_step: the i_print windows over both runs "
                 "(the loop's own clock: scene loads and pool builds not "
                 "included)")
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        return fwd, bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _depth_kernel_holds(dev, args, data, state) -> dict:
    """Both kernels at the depth topology (input 57 padded to 64, views 3
    + a 4-channel camera embedding padded to 32, per ray; folded heads;
    softplus10 outside the kernel) on the inputs the path itself gives
    them: every forward and backward call of one depth step of the trained
    ``state`` on 1024 rays of train view 0 (the coarse and fine passes),
    and the forward calls of one 32,768-ray eval chunk of test view 0; in
    fp32 and bf16.

    Forward: against the plain version, 1e-4 fp32 / 2e-2 bf16 x max(1,
    max|raw|).  Backward (``_bwd_hold``): the recorded call's inputs with a
    seeded random cotangent on every point, against the plain version,
    relative L2 per block, dv included, 1e-3 fp32 / 2e-2 bf16; in fp32
    beside both evaluations' distance from the plain version summed in
    float64."""
    import dataclasses

    from plnerf_torch.cli import run_depth
    from plnerf_torch.core import rays as raysmod
    from plnerf_torch.core.render import make_ray_batch
    from plnerf_torch.eval import images as EI
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import step as tstep

    mcfg, _, setup = run_depth.build_configs(args)

    def d(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    batch = run_depth.depth_batch(
        d(data.images), d(data.poses), d(data.intrinsics),
        d(np.asarray(data.gt_depths)[..., 0]),
        d(np.asarray(data.gt_valid_depths, np.float32)), 0, N_RAND,
        data.near, data.far, True,
        torch.Generator(device=dev).manual_seed(13))
    ti = int(data.i_split[2][0])
    ro, rd = raysmod.get_rays_pixelcenter(
        int(data.hwf[0]), int(data.hwf[1]), data.intrinsics[ti],
        d(np.asarray(data.poses[ti])[:3, :4]))
    eval_rays = make_ray_batch(ro, rd, data.near, data.far, True)[0][
        :R_CHUNK]
    calls = []
    # the path's forward goes through forward_cuda in fp32 training (with
    # its activations buffer), else through fused_mlp.forward (the op), its
    # backward through backward_cuda: each records (p, x, v, v_div, ...)
    fwd, fwd_cuda = fused_mlp.forward, fused_mlp.forward_cuda
    bwd = fused_mlp.backward_cuda

    def record(kind, fn):
        def wrapped(*a):
            calls.append((kind, a))
            return fn(*a)
        return wrapped

    errs, bwd_errs, rels = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        s = dataclasses.replace(setup, rcfg=dataclasses.replace(
            setup.rcfg, mlp_dtype=dtype))
        calls.clear()
        fused_mlp.forward = record("fwd_train", fwd)
        fused_mlp.forward_cuda = record("fwd_train", fwd_cuda)
        fused_mlp.backward_cuda = record("bwd_train", bwd)
        try:
            tstep.depth_grads(s, state, batch,
                              torch.Generator(device=dev).manual_seed(14))
            fused_mlp.forward_cuda = fwd_cuda
            fused_mlp.forward = record("fwd_eval", fwd)
            EI.render_chunks(state.params_coarse, state.params_fine,
                             eval_rays, mcfg, EI.test_render_config(
                                 s.rcfg, perturb=False), R_CHUNK, 0,
                             ("rgb_map",))
        finally:
            fused_mlp.forward, fused_mlp.forward_cuda = fwd, fwd_cuda
            fused_mlp.backward_cuda = bwd
        for o in (state.opt_fine, state.opt_ss, state.opt_latent):
            o.zero_grad(set_to_none=True)
        kinds = [k for k, _ in calls]
        if kinds.count("fwd_train") != 2 or kinds.count("bwd_train") != 2 \
                or kinds.count("fwd_eval") != 2:
            raise AssertionError(f"depth path {dtype}: kernel calls {kinds}")
        with torch.no_grad():
            for i, (kind, a) in enumerate(calls):
                p, x, v, v_div = a[:4]
                if (x.shape[1], v.shape[1]) != (64, 32):
                    raise AssertionError(f"depth topology packed as x "
                                         f"{tuple(x.shape)}, v "
                                         f"{tuple(v.shape)}")
                key = f"{kind}{i}_{x.shape[0]}_{dtype}"
                # the activations buffer the call was given: fp32 training
                # keeps the forward's for the backward
                at = 4 if kind.startswith("fwd") else 5
                acts = a[at] if len(a) > at else None
                if (acts is not None) != (dtype == "float32" and
                                          kind != "fwd_eval"):
                    raise AssertionError(f"depth path {dtype}: {kind} call "
                                         f"{i} given activations: "
                                         f"{acts is not None}")
                if kind.startswith("fwd"):
                    _hold(key, p, x, v, v_div, errs, acts)
                    continue
                cot = torch.randn(a[4].shape, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(15))
                _bwd_hold(key, p, x, v, v_div, cot, bwd_errs, rels, acts)
        del calls[:]
        torch.cuda.empty_cache()
    return {"fwd_max_abs_err": errs, "bwd_max_abs_err": bwd_errs,
            "bwd_rel_l2_err": rels,
            "tolerance": {
                "forward": "1e-4 fp32, 2e-2 bf16 x max(1, max|raw|)",
                "backward": "relative L2 per block against the plain "
                            "version, 1e-3 fp32, 2e-2 bf16"}}


def _depth_grads(state) -> dict:
    """The .grad of every tensor the depth step trains, on the CPU."""
    out = _grads(state)
    for name in ("depth_scales", "depth_shifts", "cam_embeddings"):
        out[name] = getattr(state, name).grad.detach().cpu().clone()
    return out


def _depth_card_vs_cpu(dev, args, data) -> dict:
    """Step 1 of ``make_depth_train_step`` from one state on the card (the
    kernels) and on the CPU (their plain versions): 256 rays of train view
    0 and the renderer's draws made with numpy and injected on both, space
    carving on from the first step.  Grads (before the clip) of both
    networks to 1e-3 relative L2 over all and 1e-2 per tensor (see
    phase_train_reference), of the scales, shifts and embeddings to 1e-3
    each; the step's losses to 1e-3 relative."""
    import dataclasses

    from plnerf_torch.cli import run_depth
    from plnerf_torch.train import step as tstep

    _, _, setup = run_depth.build_configs(args)
    setup = dataclasses.replace(setup, warm_start_nerf=0)
    host_setup = dataclasses.replace(setup, rcfg=dataclasses.replace(
        setup.rcfg, use_fused_mlp=True, fused_fold_heads=True))
    n_img = data.images.shape[0]
    rng = np.random.default_rng(11)
    R = 256
    g = torch.Generator().manual_seed(12)

    def cpu(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    valid = np.asarray(data.gt_valid_depths, np.float32)
    batch = run_depth.depth_batch(
        cpu(data.images), cpu(data.poses), cpu(data.intrinsics),
        cpu(np.asarray(data.gt_depths)[..., 0]), cpu(valid), 0, R,
        data.near, data.far, True, g)
    draws = {"t_rand": rng.uniform(size=(R, N_COARSE)),
             "u": rng.uniform(size=(R, N_FINE)),
             "u_hyp": rng.uniform(size=(R, N_FINE))}
    card = tstep.init_state(torch.Generator(device=dev).manual_seed(3),
                            setup, dev, n_images=n_img)
    host = tstep.init_state(None, host_setup, "cpu", n_images=n_img)
    host.load_state_dict(card.state_dict())
    runs = {}
    for name, state, s in (("card", card, setup), ("cpu", host, host_setup)):
        d = state.depth_scales.device
        b = {k: (v.to(d) if isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
        ov = {k: torch.as_tensor(v, dtype=torch.float32, device=d)
              for k, v in draws.items()}
        tstep.depth_grads(s, state, b, None, ov)
        grads = _depth_grads(state)
        _, m = tstep.make_depth_train_step(s)(state, b, None, ov)
        runs[name] = {"grads": grads,
                      "losses": {k: float(m[k]) for k in (
                          "loss", "img_loss", "img_loss0",
                          "space_carving_loss")}}
    gpu, cpu_ = runs["card"], runs["cpu"]
    nets = {k: v for k, v in cpu_["grads"].items() if k[:2] in ("c.", "f.")}
    errs = _grad_errs(gpu["grads"], nets)
    for name in ("depth_scales", "depth_shifts", "cam_embeddings"):
        errs[name] = rel_l2(gpu["grads"][name], cpu_["grads"][name])
    loss_err = {k: abs(gpu["losses"][k] / cpu_["losses"][k] - 1)
                for k in gpu["losses"]}
    worst = max((k for k in nets), key=errs.get)
    if not (errs["all"] <= 1e-3 and errs[worst] <= 1e-2
            and max(errs[n] for n in ("depth_scales", "depth_shifts",
                                      "cam_embeddings")) <= 1e-3
            and max(loss_err.values()) <= 1e-3):
        raise AssertionError(f"depth step 1 card vs CPU: grads {errs}, "
                             f"losses {loss_err}")
    return {"rays": R, "losses_card": gpu["losses"],
            "losses_cpu": cpu_["losses"], "loss_rel_err": loss_err,
            "grad_rel_l2_err": {k: errs[k] for k in (
                "all", worst, "depth_scales", "depth_shifts",
                "cam_embeddings")},
            "tolerance": "grads 1e-3 over both networks, 1e-2 per network "
                         "tensor, 1e-3 for scales / shifts / embeddings; "
                         "losses 1e-3 relative"}


def _depth_occ_run(run, expect, train, ckpt, runs, launches) -> None:
    """The depth driver with ``--occ_grid``: ``DEPTH_OCC_STEPS`` steps,
    the grid warming up for ``DEPTH_OCC_WARMUP``, then guiding; checks that
    it guides every step past the warm-up and writes its sidecar, and logs
    on the occ phase's line."""
    name = "depth_occ"
    run(name, train + [
        "--occ_grid", "--occ_warmup", str(DEPTH_OCC_WARMUP),
        "--num_iterations", str(DEPTH_OCC_STEPS), "--i_print", "10",
        "--i_img", "1000000", "--i_weights", str(DEPTH_OCC_STEPS),
        "--expname", name])
    expect(name, 2 * DEPTH_OCC_STEPS, 2 * DEPTH_OCC_STEPS)
    exp = os.path.join(ckpt, name)
    recs = _records(exp, "train/loss")
    frac = {k: r["train/occ_ray_frac"] for k, r in recs.items()
            if "train/occ_ray_frac" in r}
    if sorted(frac) != [k for k in sorted(recs) if k > DEPTH_OCC_WARMUP] \
            or not os.path.exists(os.path.join(
                exp, f"{DEPTH_OCC_STEPS:06d}.occ")):
        raise AssertionError(f"depth driver --occ_grid: occ_ray_frac {frac}")
    log("occ", part="depth_driver", card=card_line(), recipe=DEPTH_TRAIN,
        steps=DEPTH_OCC_STEPS, warmup=DEPTH_OCC_WARMUP, occ_ray_frac=frac,
        train_loss={k: r["train/loss"] for k, r in recs.items()},
        space_carving_loss={k: r.get("train/space_carving_loss")
                            for k, r in recs.items()},
        ms_per_step_by_window={k: 1e3 / r["train/steps_per_sec"]
                               for k, r in recs.items()},
        run_s=runs[name], launches=launches[name])


def phase_depth(dev, keep=None):
    """Returns (forward launches, backward launches) of the depth runs.
    ``keep``: a directory for the scene and the checkpoints
    (``keep/data/mobj``, ``keep/ckpt/depth``, left for the video phase),
    else a temporary one."""
    import functools
    import shutil
    import tempfile

    from plnerf_torch.checkpoint import io as ckio
    from plnerf_torch.cli import config, run_depth
    from plnerf_torch.data.synthetic import write_blender2_depth_scene
    from plnerf_torch.eval import images as EI
    from plnerf_torch.train import camera_opt

    t_phase = time.perf_counter()
    root = keep or tempfile.mkdtemp(prefix="plnerf_depth_")
    try:
        data_dir, ckpt = (os.path.join(root, "data"),
                          os.path.join(root, "ckpt"))
        t0 = time.perf_counter()
        write_blender2_depth_scene(
            os.path.join(data_dir, "mobj"), DEPTH_VIEWS, DEPTH_SIZE,
            DEPTH_SIZE, LEGO_CAMERA_ANGLE_X, seed=0,
            workers=min(8, os.cpu_count() or 1))
        scene_s = time.perf_counter() - t0
        where = ["--ckpt_dir", ckpt, "--expname", "depth", "--data_dir",
                 data_dir, "--scene_id", "mobj", "--dataset",
                 "blender2_depth", "--set_near_plane", "2.0",
                 "--white_bkgd"]
        exp = os.path.join(ckpt, "depth")
        size = DEPTH_SIZE * DEPTH_SIZE
        eval_chunks = -(-size // R_CHUNK)
        cam_batches = size // min(2 * N_RAND, size)
        n_test = len(range(0, DEPTH_VIEWS["test"], 8))
        run, expect, launches, runs = _driver_runs(run_depth.main)

        train = ["train"] + where + DEPTH_TRAIN
        state = run("train", train + ["--num_iterations", str(DEPTH_STEPS)])
        # two val renders (i_img at 150, 300), two launches per chunk each
        expect("train", 2 * DEPTH_STEPS + 2 * 2 * eval_chunks,
               2 * DEPTH_STEPS)
        state = run("resume", train + ["--num_iterations",
                                       str(DEPTH_RESUME_STEPS)])
        resumed = DEPTH_RESUME_STEPS - DEPTH_STEPS
        expect("resume", 2 * resumed, 2 * resumed)
        ckpts = [os.path.basename(p) for p in ckio.list_checkpoints(exp)]
        if state.step != DEPTH_RESUME_STEPS or ckpts != [
                "000150.ckpt", "000300.ckpt", "000350.ckpt"]:
            raise AssertionError(f"step {state.step}, checkpoints {ckpts}")
        recs = _records(exp, "train/loss")
        steps = sorted(recs)
        losses = {k: recs[k]["train/loss"] for k in steps}
        sc = {k: recs[k]["train/space_carving_loss"] for k in steps}
        scale = {k: recs[k]["train/depth_scale_mean"] for k in steps}
        shift = {k: recs[k]["train/depth_shift_mean"] for k in steps}
        if not (np.isfinite(list(losses.values())).all()
                and losses[steps[-1]] < losses[steps[0]]):
            raise AssertionError(f"loss did not fall: {losses}")
        if not sc[steps[-1]] < sc[steps[0]]:
            raise AssertionError(f"space-carving loss did not fall: {sc}")
        frozen = [k for k in steps if k >= DEPTH_FREEZE]
        if not (len({(scale[k], shift[k]) for k in frozen}) == 1
                and (scale[DEPTH_FREEZE], shift[DEPTH_FREEZE]) != (
                    scale[steps[0]], shift[steps[0]])):
            raise AssertionError(f"scale / shift means {scale} {shift}: "
                                 f"they must move, then hold from "
                                 f"{DEPTH_FREEZE}")

        # the kernels on the path's own inputs, at the trained state
        test = ["test", "--eval_det"] + where
        args = config.resolve_args(run_depth.config_parser().parse_args(
            test))
        mcfg, rcfg, _ = run_depth.build_configs(args)
        data = run_depth.load_depth_dataset(args)
        holds = _depth_kernel_holds(dev, args, data, state)

        # eval: test-time camera optimization (the model trained its
        # embeddings) cut from 100 epochs per view to DEPTH_CAM_EPOCHS
        scores = {}
        lp_path = write_lpips_weights(os.path.join(root, "lpips_alex.npz"))
        orig = run_depth.optimize_camera_embedding
        run_depth.optimize_camera_embedding = functools.partial(
            orig, epochs=DEPTH_CAM_EPOCHS)
        try:
            for name, extra in (("test", ["--lpips_weights", lp_path]),
                                ("test_init", ["--no_reload"])):
                mm = run(name, test + extra)
                if name == "test":
                    depth_lpips = _lpips_row(os.path.join(
                        exp, f"test_images_linear_{N_COARSE}_{N_FINE}"
                        "with_optimization_mobj", "metrics.txt"))
                # a camera-optimization batch: both passes forward, the
                # fine pass backward (its loss is the fine colour's; the
                # importance samples are detached)
                batches = DEPTH_CAM_EPOCHS * cam_batches
                expect(name, n_test * (2 * batches + 2 * eval_chunks),
                       n_test * batches)
                scores[name] = {k: mm.get(k) for k in (
                    "psnr", "ssim", "depth_rmse", "psnr0")}
        finally:
            run_depth.optimize_camera_embedding = orig
        if not scores["test"]["depth_rmse"] < scores["test_init"][
                "depth_rmse"]:
            raise AssertionError(f"held-out depth RMSE {scores}")
        result_dir = os.path.join(
            exp, f"test_images_linear_{N_COARSE}_{N_FINE}"
                 "with_optimization_mobj")
        with open(os.path.join(result_dir, "metrics.txt")) as f:
            text = f.read()
        if "depth_rmse: " not in text or "psnr: " not in text:
            raise AssertionError(f"metrics.txt: {text!r}")

        err = run("samples_error", ["test_samples_error"] + test[1:])
        expect("samples_error", 2 * n_test * eval_chunks, 0)
        with open(os.path.join(exp, f"test_predicted_samples_error_{N_FINE}",
                               "metrics_depth_samples.txt")) as f:
            k, v = f.read().split(": ")
        if k != "importance_sampling_error" or not np.isfinite(float(v)):
            raise AssertionError(f"metrics_depth_samples.txt: {k}: {v}")

        # camera optimization on one test view, called directly
        ti = int(data.i_split[2][0])
        test_rcfg = run_depth.eval_render_config(args, rcfg)
        history = []
        t = time.perf_counter()
        emb = camera_opt.optimize_camera_embedding(
            state.params_coarse, state.params_fine, data.images[ti],
            data.poses[ti], data.intrinsics[ti], mcfg, test_rcfg,
            data.near, data.far, n_rand=N_RAND, epochs=DEPTH_CAM_EPOCHS,
            history=history)
        cam_s = time.perf_counter() - t
        if not (np.isfinite(history).all() and max(history) >= history[0]
                and torch.isfinite(emb).all()):
            raise AssertionError(f"camera optimization PSNRs {history}")
        views = {}
        for tag, e in (("zero", None), ("best", emb)):
            out = EI.render_image(
                state.params_coarse, state.params_fine, data.poses[ti],
                data.hwf, data.intrinsics[ti], mcfg, test_rcfg,
                near=data.near, far=data.far, pixel_center=True,
                cam_embedding=e)
            views[tag] = float(-10 * np.log10(np.mean(
                (out["rgb_map"] - data.images[ti]) ** 2)))
        reference = _depth_card_vs_cpu(dev, args, data)

        # two seeded runs past the warm start must repeat bit for bit
        repeat = _repeat(run, expect, train + [
            "--num_iterations", str(DEPTH_REPEAT_STEPS), "--i_print", "10",
            "--i_img", "1000000", "--i_weights", str(DEPTH_REPEAT_STEPS)],
            ckpt, "repeat", DEPTH_REPEAT_STEPS,
            ("train/loss", "train/img_loss", "train/img_loss0",
             "train/space_carving_loss"))
        _depth_occ_run(run, expect, train, ckpt, runs, launches)

        window_s = {k: DEPTH_PRINT / r["train/steps_per_sec"]
                    for k, r in recs.items()}
        log("depth", card=card_line(), scene={
            "views": DEPTH_VIEWS, "read_test_views": n_test,
            "size": DEPTH_SIZE, "write_s": scene_s},
            recipe=DEPTH_TRAIN, steps=DEPTH_RESUME_STEPS,
            resumed_from=DEPTH_STEPS, checkpoints=ckpts,
            train_loss=losses, space_carving_loss=sc,
            depth_scale_mean=scale, depth_shift_mean=shift,
            train_psnr={k: r["train/psnr"] for k, r in recs.items()},
            val={k: {m: r.get(f"val/{m}") for m in ("psnr", "depth_rmse")}
                 for k, r in _records(exp, "val/psnr").items()},
            ms_per_step=1e3 * sum(window_s.values()) / DEPTH_RESUME_STEPS,
            ms_per_step_by_window={k: 1e3 * v / DEPTH_PRINT
                                   for k, v in window_s.items()},
            s_per_test_image=runs["test"] / n_test,
            s_per_samples_error_image=runs["samples_error"] / n_test,
            run_s=runs, scores=scores, lpips_350=depth_lpips,
            importance_sampling_error=err.get("importance_sampling_error"),
            camera_opt={"view": ti, "epochs": DEPTH_CAM_EPOCHS,
                        "batches": cam_batches, "psnr_by_epoch": history,
                        "psnr_render_zero": views["zero"],
                        "psnr_render_best": views["best"], "s": cam_s},
            kernel_holds=holds, card_vs_cpu_step1=reference,
            repeat=repeat, launches=launches, launches_per_train_step={
                "fused_mlp_fwd": 2.0, "fused_mlp_bwd": 2.0},
            phase_s=time.perf_counter() - t_phase,
            note="ms_per_step: the i_print windows' times summed over the "
                 "run (val renders and checkpoints included); s per test "
                 "image: the test task's wall time over its images, "
                 f"{DEPTH_CAM_EPOCHS} epochs of camera optimization per "
                 "image included (the driver's 100 cut)")
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        return fwd, bwd
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


def _leaves(tree, prefix: str = ""):
    """(name, tensor) of every floating tensor in nested dicts / lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield prefix[:-1], tree


def _state_diff(a, b) -> dict:
    """The floating tensors of two nested state dicts that differ (names,
    count, the largest |a - b|); both must hold the same names."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if la.keys() != lb.keys():
        raise ValueError(f"state dicts differ in names: "
                         f"{sorted(la.keys() ^ lb.keys())[:4]}")
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    worst = max((float((la[k] - lb[k]).abs().max()) for k in bad),
                default=0.0)
    return {"tensors": len(bad), "of": len(la), "first": bad[:4],
            "max_abs": worst}


def _repeat(run, expect, argv, exp_root, name, steps, keys) -> dict:
    """Two runs of the driver command ``argv`` from one seed, as
    experiments ``{name}_a`` and ``{name}_b`` (two launches of each kernel
    per step, no eval render): every logged ``keys`` value, every tensor of
    the final state and, where there is one, of the final ``.occ`` sidecar
    must be bit-equal; raises otherwise."""
    states, recs, grids = {}, [], []
    for tag in ("a", "b"):
        exp = f"{name}_{tag}"
        states[tag] = run(exp, argv + ["--expname", exp])
        expect(exp, 2 * steps, 2 * steps)
        recs.append(_records(os.path.join(exp_root, exp), "train/loss"))
        sidecar = os.path.join(exp_root, exp, f"{steps:06d}.occ")
        if os.path.exists(sidecar):
            grids.append(torch.load(sidecar, weights_only=True))
    differ = [k for k in recs[0]
              if any(recs[0][k].get(q) != recs[1].get(k, {}).get(q)
                     for q in keys)]
    out = {"steps": steps, "logged_steps": sorted(recs[0]),
           "differing_logged_steps": differ,
           "state": _state_diff(states["a"].state_dict(),
                               states["b"].state_dict()),
           "grid": _state_diff(*grids) if len(grids) == 2 else None,
           "losses": {k: r["train/loss"] for k, r in recs[0].items()}}
    if (differ or out["state"]["tensors"] or len(grids) == 1
            or (out["grid"] and out["grid"]["tensors"])):
        raise AssertionError(f"{name}: two seeded runs differ: {out}")
    return out


def _occ_setup(args):
    """(mcfg, setup with the grid's config) of the occ recipe's args."""
    import dataclasses

    from plnerf_torch.cli import run_plnerf

    mcfg, rcfg, setup = run_plnerf.build_configs(args)
    return mcfg, dataclasses.replace(setup, rcfg=dataclasses.replace(
        rcfg, occ=run_plnerf.occ_cfg_from_args(args)))


def _occ_kernel_holds(dev, args, state, grid, batch, eval_rays) -> dict:
    """Both bf16 kernels on the inputs the occ path gives them: every
    forward and backward call of one guided step of the trained ``state``
    on ``batch`` (1024 rays: 32,768 coarse and 98,304 fine rows) and the
    forward calls of one 32,768-ray eval chunk with the grid (1,048,576
    and 3,145,728 rows); held as ``_depth_kernel_holds`` holds them
    (forward 2e-2 x max(1, max|raw|), backward 2e-2 relative L2 per block
    on a seeded random cotangent).  Returns the errors and the step's
    density observations (``_occ_z``, ``_occ_sigma``) on the CPU."""
    from plnerf_torch.eval import images as EI
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import step as tstep

    mcfg, setup = _occ_setup(args)
    if setup.rcfg.mlp_dtype != "bfloat16" or not setup.rcfg.use_fused_mlp:
        raise AssertionError(f"occ recipe config {setup.rcfg}")
    calls = []
    # the path's forward goes through fused_mlp.forward (the op), its
    # backward through backward_cuda: both record (p, x, v, v_div, ...)
    fwd, bwd = fused_mlp.forward, fused_mlp.backward_cuda

    def record(kind, fn):
        def wrapped(*a):
            calls.append((kind, a))
            return fn(*a)
        return wrapped

    fused_mlp.forward = record("fwd_train", fwd)
    fused_mlp.backward_cuda = record("bwd_train", bwd)
    try:
        loss, m = tstep._render_loss(
            state.params_coarse, state.params_fine,
            dict(batch, occ_grid=grid),
            torch.Generator(device=dev).manual_seed(16), setup)
        loss.backward()
        fused_mlp.forward = record("fwd_eval", fwd)
        EI.render_chunks(state.params_coarse, state.params_fine, eval_rays,
                         mcfg, EI.test_render_config(setup.rcfg,
                                                     perturb=False),
                         R_CHUNK, 0, ("rgb_map",), occ_grid=grid)
    finally:
        fused_mlp.forward, fused_mlp.backward_cuda = fwd, bwd
    for o in (state.opt_fine, state.opt_coarse):
        o.zero_grad(set_to_none=True)
    rows = {}
    for kind, a in calls:
        rows.setdefault(kind, []).append(a[1].shape[0])
    rows = {k: sorted(v) for k, v in rows.items()}
    want = {"fwd_train": [N_RAND * 32, N_RAND * 96],
            "bwd_train": [N_RAND * 32, N_RAND * 96],
            "fwd_eval": [R_CHUNK * 32, R_CHUNK * 96]}
    if rows != want:
        raise AssertionError(f"occ path kernel calls {rows}, expected {want}")
    errs, bwd_errs, rels = {}, {}, {}
    with torch.no_grad():
        for i, (kind, a) in enumerate(calls):
            p, x, v, v_div = a[:4]
            key = f"{kind}{i}_{x.shape[0]}_bfloat16"
            if kind.startswith("fwd"):
                _hold(key, p, x, v, v_div, errs)
                continue
            cot = torch.randn(a[4].shape, device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(17))
            _bwd_hold(key, p, x, v, v_div, cot, bwd_errs, rels)
    del calls[:]
    torch.cuda.empty_cache()
    return {"rows": rows, "fwd_max_abs_err": errs,
            "bwd_max_abs_err": bwd_errs, "bwd_rel_l2_err": rels,
            "tolerance": {"forward": "2e-2 x max(1, max|raw|)",
                          "backward": "relative L2 per block against the "
                                      "plain version, 2e-2"}}, {
        "z": m["_occ_z"].cpu(), "sigma": m["_occ_sigma"].cpu()}


# the updated grid on the card against the CPU: voxels whose occ may
# differ (a density EMA within rounding of the threshold), of 128^3
OCC_FLIP_BOUND = 1e-4


def _occ_card_vs_cpu(dev, args, grid, batch, obs) -> dict:
    """The grid functions on the card and on the CPU on the same inputs
    (the trained ``grid``, ``batch``'s rays, a guided step's density
    observations ``obs``): ``update_grid``, ``refresh_occ`` and
    ``occupancy_along_rays`` exactly, ``occ_guided_z_vals`` to 1e-5.  Then
    one fp32 guided step's forward and backward and its grid update from a
    fresh init, the grid and the renderer's draws (made with numpy) the
    same on both: losses to 1e-3 relative, grads to 1e-3 relative L2 over
    both networks and 1e-2 per tensor (see phase_train_reference), the
    updated grid's ``occ`` differing in at most ``OCC_FLIP_BOUND`` of the
    voxels."""
    import dataclasses

    from plnerf_torch.core import occgrid as og
    from plnerf_torch.train import step as tstep

    _, setup = _occ_setup(args)
    cfg = setup.rcfg.occ
    cpu_grid = {k: v.cpu() for k, v in grid.items()}
    rays = batch["rays"].cpu()
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * obs["z"][..., None]
    exact, errs = {}, {}
    got = og.update_grid(grid, pts.to(dev), obs["sigma"].to(dev), cfg)
    ref = og.update_grid(cpu_grid, pts, obs["sigma"], cfg)
    for k in ("density", "occ"):
        exact[f"update_grid.{k}"] = torch.equal(got[k].cpu(), ref[k])
    exact["refresh_occ"] = torch.equal(og.refresh_occ(grid, cfg)["occ"].cpu(),
                                       og.refresh_occ(cpu_grid, cfg)["occ"])
    R = rays.shape[0]
    t_rand = torch.as_tensor(np.random.default_rng(18).uniform(
        size=(R, setup.rcfg.n_samples)), dtype=torch.float32)
    outs = {}
    for name, g, r, t in (("card", grid, rays.to(dev), t_rand.to(dev)),
                          ("cpu", cpu_grid, rays, t_rand)):
        parts = (r[:, 0:3], r[:, 3:6], r[:, 6:7], r[:, 7:8])
        e, o = og.occupancy_along_rays(g, *parts, cfg.candidates, cfg)
        z, frac = og.occ_guided_z_vals(g, *parts, setup.rcfg.n_samples, t,
                                       cfg)
        outs[name] = [x.cpu() for x in (e, o, z, frac)]
    exact["occupancy_along_rays.edges"] = torch.equal(outs["card"][0],
                                                      outs["cpu"][0])
    exact["occupancy_along_rays.occ"] = torch.equal(outs["card"][1],
                                                    outs["cpu"][1])
    errs["occ_guided_z_vals"] = float(
        (outs["card"][2] - outs["cpu"][2]).abs().max())
    errs["occ_ray_frac"] = float((outs["card"][3] - outs["cpu"][3]).abs())

    # one fp32 guided step from one state, grid and set of draws
    fp32 = dataclasses.replace(setup, rcfg=dataclasses.replace(
        setup.rcfg, mlp_dtype="float32"))
    rng = np.random.default_rng(19)
    n = 256
    draws = {"t_rand": rng.uniform(size=(n, fp32.rcfg.n_samples)),
             "u": rng.uniform(size=(n, fp32.rcfg.n_importance))}
    card = tstep.init_state(torch.Generator(device=dev).manual_seed(4), fp32,
                            dev)
    host = tstep.init_state(None, fp32, "cpu")
    host.load_state_dict(card.state_dict())
    step = {}
    for name, state, g in (("card", card, grid), ("cpu", host, cpu_grid)):
        d = g["occ"].device
        b = {"rays": batch["rays"][:n].to(d),
             "target": batch["target"][:n].to(d)}
        ov = {k: torch.as_tensor(v, dtype=torch.float32, device=d)
              for k, v in draws.items()}
        loss, m = tstep._render_loss(state.params_coarse, state.params_fine,
                                     dict(b, occ_grid=g), None, fp32,
                                     overrides=ov)
        loss.backward()
        new, m = tstep.apply_occ_update(fp32, g, b, m)
        step[name] = {"grads": _grads(state), "occ": new["occ"].cpu(),
                      "losses": {k: float(m[k]) for k in (
                          "loss", "img_loss", "img_loss0", "occ_ray_frac")}}
    gpu, cpu = step["card"], step["cpu"]
    grad_errs = _grad_errs(gpu["grads"], cpu["grads"])
    loss_err = {k: abs(gpu["losses"][k] / cpu["losses"][k] - 1)
                for k in gpu["losses"]}
    flips = int((gpu["occ"] != cpu["occ"]).sum())
    worst = max((k for k in grad_errs if k != "all"), key=grad_errs.get)
    out = {"exact": exact, "max_abs_err": errs, "rays": n,
           "losses_card": gpu["losses"], "losses_cpu": cpu["losses"],
           "loss_rel_err": loss_err,
           "grad_rel_l2_err": {k: grad_errs[k] for k in ("all", worst)},
           "occ_voxels_differing": flips, "voxels": gpu["occ"].numel(),
           "tolerance": {
               "grid_functions": "exact; occ_guided_z_vals 1e-5",
               "step": "losses 1e-3 relative; grads 1e-3 relative L2 over "
                       "both networks, 1e-2 per tensor",
               "updated_grid": f"occ differs in at most {OCC_FLIP_BOUND} "
                               "of the voxels"}}
    if not (all(exact.values()) and errs["occ_guided_z_vals"] <= 1e-5
            and errs["occ_ray_frac"] <= 1e-6
            and max(loss_err.values()) <= 1e-3 and grad_errs["all"] <= 1e-3
            and grad_errs[worst] <= 1e-2
            and flips <= OCC_FLIP_BOUND * gpu["occ"].numel()):
        raise AssertionError(f"occ card vs CPU: {out}")
    return out


def phase_occ(dev, scenes=None):
    """Returns (forward launches, backward launches) of the occ runs.
    ``scenes``: where the sphere scene is or goes (``sphere_data``)."""
    import shutil
    import tempfile

    from plnerf_torch.cli import config
    from plnerf_torch.cli.datasets import load_dataset
    from plnerf_torch.core import rays as raysmod
    from plnerf_torch.core.render import make_ray_batch
    from plnerf_torch.train import batching

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plnerf_occ_")
    try:
        ckpt = os.path.join(root, "ckpt")
        data, scene_s = sphere_data(scenes or os.path.join(root, "data"))
        here = os.path.dirname(os.path.abspath(__file__))
        occ_config = os.path.join(here, "configs", "blender_linear_occ.txt")
        uni_config = os.path.join(here, "configs", "blender_linear.txt")
        where = ["--ckpt_dir", ckpt, "--data_dir", data, "--scene_id",
                 "sphere"]
        eval_chunks = -(-DRIVER_SIZE * DRIVER_SIZE // R_CHUNK)
        n_test = DRIVER_VIEWS["test"]
        run, expect, launches, runs = _driver_runs()

        # the occ arm: 300 steps, a resume to 400 from the sidecar, test
        train = (["--config", occ_config, "--task", "train"] + where
                 + ["--expname", "occ"] + OCC_ARM)
        run("train", train + ["--num_iterations", str(OCC_STEPS)])
        expect("train", 2 * OCC_STEPS, 2 * OCC_STEPS)
        state = run("resume", train + ["--num_iterations",
                                       str(OCC_RESUME_STEPS)])
        resumed = OCC_RESUME_STEPS - OCC_STEPS
        # two val renders (i_img at 600, 1200), two launches per chunk each
        expect("resume", 2 * resumed + 2 * 2 * eval_chunks, 2 * resumed)
        exp = os.path.join(ckpt, "occ")
        files = sorted(f for f in os.listdir(exp) if f[0].isdigit())
        if state.step != OCC_RESUME_STEPS or files != [
                f"{s:06d}.{x}" for s in range(300, OCC_RESUME_STEPS + 1, 300)
                for x in ("ckpt", "occ")]:
            raise AssertionError(f"step {state.step}, files {files}")
        recs = _records(exp, "train/loss")
        frac = {k: r["train/occ_ray_frac"] for k, r in recs.items()
                if "train/occ_ray_frac" in r}
        guided = [k for k in sorted(recs) if k > OCC_WARMUP]
        first = min(frac)
        if sorted(frac) != guided or not frac[OCC_RESUME_STEPS] < \
                frac[first]:
            raise AssertionError(f"occ_ray_frac {frac}: the grid must guide "
                                 f"every step past {OCC_WARMUP}, the resume "
                                 "at once, and carve")
        losses = {k: r["train/loss"] for k, r in recs.items()}
        if not (np.isfinite(list(losses.values())).all()
                and losses[OCC_RESUME_STEPS] < losses[OCC_PRINT]):
            raise AssertionError(f"loss did not fall: {losses}")
        grid = torch.load(os.path.join(exp, f"{OCC_RESUME_STEPS:06d}.occ"),
                          map_location=dev, weights_only=True)
        g = grid["occ"].shape[0]
        occupied = float(grid["occ"].mean())
        if float(grid["occ"][g // 2, g // 2, g // 2]) != 1.0:
            raise AssertionError(f"grid at {OCC_RESUME_STEPS}: occupied "
                                 f"share {occupied}, centre voxel "
                                 f"{grid['occ'][g // 2, g // 2, g // 2]}")
        test = ["--task", "test", "--white_bkgd"] + where
        mm = run("test", test + ["--expname", "occ"])
        expect("test", 2 * n_test * eval_chunks, 0)

        # the uniform arm at the same dtype, same scene and steps
        run("uniform_train", ["--config", uni_config, "--task", "train",
                              "--mlp_dtype", "bfloat16"] + where
            + ["--expname", "uniform"] + OCC_TRAIN
            + ["--num_iterations", str(OCC_RESUME_STEPS)])
        expect("uniform_train", 2 * OCC_RESUME_STEPS
               + 2 * 2 * eval_chunks, 2 * OCC_RESUME_STEPS)
        mm_u = run("uniform_test", test + ["--expname", "uniform"])
        expect("uniform_test", 2 * n_test * eval_chunks, 0)
        recs_u = _records(os.path.join(ckpt, "uniform"), "train/loss")

        # the kernels on the occ path's own inputs, at the trained state
        args = config.resolve_args(config.config_parser().parse_args(
            test + ["--expname", "occ"]))
        bundle = load_dataset(args)
        imgs = torch.as_tensor(np.asarray(bundle.data.images, np.float32),
                               device=dev)
        poses = torch.as_tensor(np.asarray(bundle.data.poses, np.float32)[
            :, :3, :4], device=dev)
        rays, target, _ = batching.sample_one_image_batch(
            imgs, poses, bundle.data.K,
            torch.as_tensor(np.asarray(bundle.i_train), device=dev),
            torch.Generator(device=dev).manual_seed(20), N_RAND,
            bundle.near, bundle.far, True)
        batch = {"rays": rays, "target": target}
        ti = int(bundle.i_test[0])
        H, W = DRIVER_SIZE, DRIVER_SIZE
        ro, rd = raysmod.get_rays(H, W, np.asarray(bundle.data.K),
                                  poses[ti])
        eval_rays = make_ray_batch(ro, rd, bundle.near, bundle.far,
                                   True)[0][:R_CHUNK]
        holds, obs = _occ_kernel_holds(dev, args, state, grid, batch,
                                       eval_rays)
        reference = _occ_card_vs_cpu(dev, args, grid, batch, obs)

        # two seeded runs of the first guided steps
        repeat = _repeat(run, expect, [
            "--config", occ_config, "--task", "train"] + where + OCC_REPEAT,
            ckpt, "repeat", OCC_REPEAT_STEPS,
            ("train/loss", "train/img_loss", "train/img_loss0",
             "train/occ_ray_frac"))

        def windows(rs):
            return {k: 1e3 / r["train/steps_per_sec"]
                    for k, r in sorted(rs.items())}

        def over(w, keep):
            ks = [k for k in w if keep(k)]
            return sum(w[k] for k in ks) / len(ks)

        w_occ, w_uni = windows(recs), windows(recs_u)
        occ_ms = over(w_occ, lambda k: True)
        uni_ms = over(w_uni, lambda k: True)
        log("occ", card=card_line(), scene={
            "views": DRIVER_VIEWS, "size": DRIVER_SIZE, "write_s": scene_s},
            config="configs/blender_linear_occ.txt", recipe=OCC_ARM,
            steps=OCC_RESUME_STEPS, resumed_from=OCC_STEPS,
            files=files,
            occ_arm={
                "ms_per_step": occ_ms,
                "ms_per_step_warmup_windows": over(
                    w_occ, lambda k: k <= OCC_WARMUP),
                "ms_per_step_guided_windows": over(
                    w_occ, lambda k: k > OCC_WARMUP),
                "ms_per_step_by_window": w_occ,
                "s_per_test_image": runs["test"] / n_test,
                "psnr": mm.get("psnr"), "ssim": mm.get("ssim"),
                "psnr0": mm.get("psnr0"), "train_loss": losses,
                "occ_ray_frac": frac, "occ_ray_frac_first": frac[first],
                "occ_ray_frac_end": frac[OCC_RESUME_STEPS],
                "grid_occupied_share": occupied,
                "grid_centre_voxel_occupied": True},
            uniform_bf16_arm={
                "config": "configs/blender_linear.txt --mlp_dtype bfloat16",
                "ms_per_step": uni_ms,
                "ms_per_step_by_window": w_uni,
                "s_per_test_image": runs["uniform_test"] / n_test,
                "psnr": mm_u.get("psnr"), "ssim": mm_u.get("ssim"),
                "psnr0": mm_u.get("psnr0"),
                "train_loss": {k: r["train/loss"] for k, r in
                               recs_u.items()}},
            occ_over_uniform_ms=occ_ms / uni_ms,
            kernel_holds=holds, card_vs_cpu=reference, repeat=repeat,
            run_s=runs, launches=launches, launches_per_train_step={
                "fused_mlp_fwd": 2.0, "fused_mlp_bwd": 2.0},
            phase_s=time.perf_counter() - t_phase,
            note="ms per step: each i_print window's time over its steps "
                 "(from metrics.jsonl's steps_per_sec; val renders and "
                 "checkpoints inside), averaged over the windows; the "
                 f"warm-up windows end at {OCC_WARMUP} (32 uniform coarse "
                 "samples), the guided ones follow; s per test image: the "
                 "test task's wall time over its images")
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        return fwd, bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _frame_names(n: int) -> list:
    """The JAX drivers' frame files of an n-frame path: ``render_path``'s
    ``{i:03d}.png`` and ``write_video``'s PNG fallback ``video/{i:03d}.png``
    (imageio without ffmpeg, ``plnerf/eval/images.py:459-473``)."""
    return sorted([f"{i:03d}.png" for i in range(n)]
                  + [f"video/{i:03d}.png" for i in range(n)])


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def phase_video(dev, work):
    """Returns (forward launches, backward launches) of the video runs
    (the backward's from the continuation's steps).  ``work``: the
    directories of the driver phase (``driver``), its scenes (``scenes``)
    and the depth phase (``depth``), each holding its checkpoints."""
    import shutil

    from plnerf_torch.cli import config, run_depth, run_plnerf
    from plnerf_torch.data.png import read_png
    from plnerf_torch.eval import images as EI
    from plnerf_torch.utils.misc import to8b

    t_phase = time.perf_counter()
    ckpt = os.path.join(work["driver"], "ckpt")
    where = ["--ckpt_dir", ckpt, "--expname", "smoke", "--data_dir",
             work["scenes"], "--scene_id", "sphere", "--white_bkgd"]
    config_txt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "blender_linear.txt")
    train = ["--config", config_txt, "--task", "train"] + where \
        + DRIVER_TRAIN
    run, expect, launches, runs = _driver_runs()
    small = DRIVER_SIZE // VIDEO_FACTOR
    per_frame, other = {}, {}

    def frames(name, argv, folder, n, size, runner=run):
        """``runner(name, argv)`` with every frame's render timed; checks
        the frame files of ``folder`` and that a decoded frame equals the
        returned array; returns the frames."""
        with _Recording(EI, "render_image") as rec:
            rgbs = runner(name, argv)
        names = _tree(folder)
        extra = [f for f in names if f not in _frame_names(n)]
        if (len(rec.calls) != n or rgbs.shape != (n, size, size, 3)
                or sorted(set(names) - set(extra)) != _frame_names(n)):
            raise AssertionError(f"video {name}: {len(rec.calls)} frames, "
                                 f"{rgbs.shape}, files {names[:4]}...")
        last = read_png(os.path.join(folder, f"{n - 1:03d}.png"))
        if not (np.array_equal(last, to8b(rgbs[-1]))
                and np.isfinite(rgbs).all()):
            raise AssertionError(f"video {name}: frame {n - 1} on disk")
        s = [t for t, _ in rec.calls]
        per_frame[name] = {"frames": n, "size": size,
                           "s_per_frame": statistics.median(s),
                           "s_per_frame_mean": sum(s) / n,
                           "other_files": len(extra)}
        other[name] = sorted(extra)
        return rgbs

    exp = os.path.join(ckpt, "smoke")
    n_path = VIDEO_FRAMES
    # 1. the hemisphere path at render factor 4 (100x100)
    frames("video", ["--task", "video", "--render_factor",
                     str(VIDEO_FACTOR)] + where,
           os.path.join(exp, f"renderonly_path_{DRIVER_RESUME_STEPS:06d}"),
           n_path, small)
    expect("video", 2 * n_path * -(-small * small // R_CHUNK), 0)
    # 2. --render_only --render_test: the test views at 400x400
    n_test = DRIVER_VIEWS["test"]
    frames("render_only", train + ["--render_only", "--render_test"],
           os.path.join(exp, f"renderonly_test_{DRIVER_RESUME_STEPS:06d}"),
           n_test, DRIVER_SIZE)
    eval_chunks = -(-DRIVER_SIZE * DRIVER_SIZE // R_CHUNK)
    expect("render_only", 2 * n_test * eval_chunks, 0)
    # 3. a continuation of a copy of the run, whose --i_video fires once
    cont = os.path.join(ckpt, "smoke_video")
    shutil.copytree(exp, cont, ignore=shutil.ignore_patterns(
        "test_images*", "renderonly*", "val"))
    end = DRIVER_RESUME_STEPS + VIDEO_CONT_STEPS
    fire = DRIVER_RESUME_STEPS + VIDEO_EVERY
    state = run("i_video", train + [
        "--expname", "smoke_video", "--num_iterations", str(end),
        "--i_video", str(VIDEO_EVERY), "--render_factor",
        str(VIDEO_FACTOR)])
    expect("i_video", 2 * VIDEO_CONT_STEPS
           + 2 * n_path * -(-small * small // R_CHUNK),
           2 * VIDEO_CONT_STEPS)
    fired = sorted(d for d in os.listdir(cont) if d.startswith("renderonly"))
    if state.step != end or fired != [f"renderonly_path_{fire:06d}"] or \
            _tree(os.path.join(cont, fired[0])) != _frame_names(n_path):
        raise AssertionError(f"--i_video: step {state.step}, {fired}")
    # 4. the depth driver's video: the 40 poses of the video split
    depth = work["depth"]
    dwhere = ["--ckpt_dir", os.path.join(depth, "ckpt"), "--expname",
              "depth", "--data_dir", os.path.join(depth, "data"),
              "--scene_id", "mobj", "--dataset", "blender2_depth",
              "--set_near_plane", "2.0", "--white_bkgd"]
    drun, dexpect, dlaunches, druns = _driver_runs(run_depth.main)
    dfolder = os.path.join(depth, "ckpt", "depth", "video")
    frames("depth_video", ["video"] + dwhere, dfolder, n_path, DEPTH_SIZE,
           runner=drun)
    runs.update(druns)
    launches.update(dlaunches)
    dexpect("depth_video", 2 * n_path * -(-DEPTH_SIZE * DEPTH_SIZE
                                          // R_CHUNK), 0)
    depth_files = other["depth_video"]
    want = sorted([f"depth_{i:03d}.png" for i in range(n_path)]
                  + [f"depthcolor_{i:03d}.png" for i in range(n_path)])
    d0 = read_png(os.path.join(dfolder, "depth_000.png"))
    c0 = read_png(os.path.join(dfolder, "depthcolor_000.png"))
    if depth_files != want or d0.dtype != np.uint16 or c0.shape != (
            DEPTH_SIZE, DEPTH_SIZE, 3):
        raise AssertionError(f"depth video files {depth_files[:4]}...")
    if other["video"] or other["render_only"]:
        raise AssertionError(f"video: other files {other}")

    # the card's --eval_det frame against the CPU's every 8th pixel
    args = config.resolve_args(config.config_parser().parse_args(
        ["--task", "video"] + where))
    _, _, setup = run_plnerf.build_configs(args)
    state400, *_ = run_plnerf._state_for_eval(args, setup)
    view = _driver_view(["--task", "video", "--render_factor",
                         str(VIDEO_FACTOR)] + where, state400, frame=0)
    log("video", card=card_line(), frames=per_frame,
        i_video={"steps": [DRIVER_RESUME_STEPS + 1, end], "fired": fire},
        view_check=view, launches=launches, run_s=runs,
        phase_s=time.perf_counter() - t_phase,
        note="s_per_frame: the median render_image call of each run "
             "(render and host copy; the PNG writes are outside it); "
             "run_s: the entry point's wall time (scene and checkpoint "
             "load, frames, PNGs)")
    return (sum(v["fused_mlp_fwd"] for v in launches.values()),
            sum(v["fused_mlp_bwd"] for v in launches.values()))


def _write_sphere_obj(path: str, n_lat: int = 16, n_lon: int = 32) -> None:
    """A latitude-longitude unit sphere as an .obj (the GT mesh whose bbox,
    +-0.25, bounds the grid): poles and the equator reach +-1 on every
    axis."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = ["v 0 0 1"]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            lines.append(f"v {np.sin(th) * np.cos(ph):.6f} "
                         f"{np.sin(th) * np.sin(ph):.6f} {np.cos(th):.6f}")
    lines.append("v 0 0 -1")
    last = 1 + (n_lat - 1) * n_lon          # 1-based index of the -z pole

    def ring(i, j):
        return 2 + (i - 1) * n_lon + j % n_lon

    for j in range(n_lon):
        lines.append(f"f 1 {ring(1, j)} {ring(1, j + 1)}")
        lines.append(f"f {last + 1} {ring(n_lat - 1, j + 1)} "
                     f"{ring(n_lat - 1, j)}")
        for i in range(1, n_lat - 1):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            lines += [f"f {a} {c} {d}", f"f {a} {d} {b}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _grid_hold(net, cfg, box, res, chunk, tol_scale, errs, key) -> None:
    """The grid through the fp32 kernel against its plain version
    (``forward_plain`` on the same packed weights and inputs) on the card;
    raises past ``tol_scale`` x max(1, max sigma)."""
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.mesh import extract as MX

    got = MX.extract_density_grid(net, cfg, *box, res, chunk, True)
    forward = fused_mlp.forward
    fused_mlp.forward = fused_mlp.forward_plain
    try:
        ref = MX.extract_density_grid(net, cfg, *box, res, chunk, True)
    finally:
        fused_mlp.forward = forward
    err = float(np.abs(got - ref).max())
    scale = max(1.0, float(ref.max()))
    errs[key] = {"max_abs_err": err, "max_sigma": float(ref.max()),
                 "points": res ** 3, "chunk": chunk}
    if not (np.isfinite(got).all() and err <= tol_scale * scale):
        raise AssertionError(f"grid {key}: max abs err {err} (max sigma "
                             f"{scale}) over {tol_scale}")


def phase_mesh(dev, work):
    """Returns the forward launches of the mesh extraction.  ``work`` as in
    ``phase_video``."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from plnerf_torch.cli import config, extract_mesh, run_plnerf
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.mesh import extract as MX
    from plnerf_torch.mesh import marching_cubes as MC

    t_phase = time.perf_counter()
    data = work["scenes"]
    ckpt = os.path.join(work["driver"], "ckpt")
    _write_sphere_obj(os.path.join(data, "nerf_meshes_reoriented",
                                   "sphere.obj"))
    out_dir = os.path.join(work["driver"], "meshes")
    argv = ["--ckpt_dir", ckpt, "--expname", "smoke", "--data_dir", data,
            "--scene_id", "sphere", "--mesh_res", str(MESH_RES),
            "--mesh_threshold", str(MESH_THRESHOLD), "--adaptive_iso",
            "--mesh_chunk", str(MESH_CHUNK), "--mesh_outdir", out_dir]
    run, expect, launches, runs = _driver_runs(extract_mesh.main)
    torch.cuda.reset_peak_memory_stats(dev)
    with _Recording(MX, "extract_density_grid") as grid_rec, \
            _Recording(MX, "marching_cubes") as mc_rec, \
            _Recording(MX, "filter_connected_components") as fc_rec, \
            _Recording(MX, "export_ply") as ply_rec:
        path = run("mesh", argv)
    peak = torch.cuda.max_memory_allocated(dev)
    n_chunks = -(-MESH_RES ** 3 // MESH_CHUNK)
    expect("mesh", n_chunks, 0)
    grid_s, grid = grid_rec.calls[0]
    mc_s, (raw_v, raw_f) = mc_rec.calls[0]
    fc_s, (clean_v, clean_f) = fc_rec.calls[0]
    ply_s = ply_rec.calls[0][0]
    want = (f"sphere_linear_res{MESH_RES}_thresh{MESH_THRESHOLD:g}"
            "_cleaned.ply")
    if os.path.basename(path) != want or os.listdir(out_dir) != [want]:
        raise AssertionError(f"mesh file {path}")
    if grid.shape != (MESH_RES,) * 3 or not np.isfinite(grid).all():
        raise AssertionError(f"grid {grid.shape}")
    if raw_f.shape[0] == 0 or clean_f.shape[0] == 0:
        raise AssertionError(f"empty mesh: raw {raw_f.shape}, cleaned "
                             f"{clean_f.shape}")
    iso = MX.extract_iso_level(grid, MESH_THRESHOLD)
    t = time.perf_counter()
    back_v, back_f = MX.load_ply(path)
    load_s = time.perf_counter() - t
    box = (np.full(3, -1.25, np.float32), np.full(3, 1.25, np.float32))
    if not (np.array_equal(back_v, clean_v) and np.array_equal(back_f,
                                                               clean_f)):
        raise AssertionError("the PLY does not read back")
    if not ((back_v >= box[0] - 1e-5).all() and (back_v <= box[1] + 1e-5)
            .all()):
        raise AssertionError(f"verts outside the bbox: {back_v.min(0)} "
                             f"{back_v.max(0)}")

    # native against numpy marching cubes on a 48^3 block the surface
    # crosses (around the first raw vertex, in grid coordinates)
    lo = np.clip(np.floor(raw_v[0]).astype(int) - MESH_BLOCK // 2, 0,
                 MESH_RES - MESH_BLOCK)
    block = grid[lo[0]:lo[0] + MESH_BLOCK, lo[1]:lo[1] + MESH_BLOCK,
                 lo[2]:lo[2] + MESH_BLOCK]
    t = time.perf_counter()
    nv, nf = MC.marching_cubes_native(block, iso)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    pv, pf = MC.marching_cubes_numpy(block, iso)
    numpy_s = time.perf_counter() - t
    mc_err = float(np.abs(nv - pv).max()) if nv.size else 0.0
    if nf.shape[0] == 0 or not np.array_equal(nf, pf) or mc_err > 1e-6:
        raise AssertionError(f"marching cubes on the block at {lo}: faces "
                             f"{nf.shape} / {pf.shape}, verts {mc_err}")

    # the grid through the kernel against its plain version on the card,
    # and the card against the CPU
    args = config.resolve_args(extract_mesh.config_parser().parse_args(
        argv + ["--task", "mesh"]))
    _, _, setup = run_plnerf.build_configs(args)
    state, _, _ = run_plnerf.restore_or_init(args, setup, dev)
    net, cfg = state.params_fine, state.params_fine.cfg
    errs = {}
    for key, (res, chunk) in MESH_HOLDS.items():
        _grid_hold(net, cfg, box, res, chunk, TOLERANCE[torch.float32],
                   errs, key)
    if MESH_HOLDS["kernel_vs_plain_160_big"][1] <= fused_mlp.FWD_CHUNK:
        raise AssertionError("the big-chunk hold is not above FWD_CHUNK")
    card = MX.extract_density_grid(net, cfg, *box, MESH_CPU_RES, MESH_CHUNK,
                                   True)
    t = time.perf_counter()
    cpu = MX.extract_density_grid(copy.deepcopy(net).to("cpu"), cfg, *box,
                                  MESH_CPU_RES, MESH_CHUNK, True)
    cpu_s = time.perf_counter() - t
    err = float(np.abs(card - cpu).max())
    errs[f"card_vs_cpu_{MESH_CPU_RES}"] = {"max_abs_err": err,
                              "max_sigma": float(cpu.max()), "cpu_s": cpu_s}
    if err > TOLERANCE[torch.float32] * max(1.0, float(cpu.max())):
        raise AssertionError(f"grid card vs CPU: {err}")

    # the 512^3 grid's device time, kernel launches apart, in one profiled
    # call; one weight pack's time
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        MX.extract_density_grid(net, cfg, *box, MESH_RES, MESH_CHUNK, True)
        torch.cuda.synchronize(dev)
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.time_range.elapsed_us() for e in dev_ev
                    if "fp32_kernel" in e.name) / 1e3
    device_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    pack_ms = cuda_ms(lambda: fused_mlp.pack_weights(
        net, cfg, torch.float32, fold_heads=True,
        vch=cfg.input_ch_views + cfg.input_ch_cam))
    n = MESH_RES ** 3
    flops = 2.0 * macs_per_point(cfg, fused_mlp.FOLDED) * n
    bound_s = flops / PEAK_FLOPS[torch.float32]
    log("mesh", card=card_line(), res=MESH_RES, chunk=MESH_CHUNK,
        points=n, bbox=[box[0].tolist(), box[1].tolist()],
        threshold=MESH_THRESHOLD, iso=iso, adaptive=True,
        grid_max=float(grid.max()), grid_mean=float(grid.mean()),
        grid_s=grid_s, points_per_s=n / grid_s, bound_s=bound_s,
        bound_by="operations", bound_share=bound_s / grid_s,
        kernel_device_ms=kernel_ms, device_ms=device_ms,
        kernel_launches=launches["mesh"]["fused_mlp_fwd"],
        pack_ms=pack_ms, pack_share=pack_ms / (1e3 * grid_s),
        pack_share_if_per_call=n_chunks * pack_ms / (1e3 * grid_s),
        marching_cubes_s=mc_s, filter_s=fc_s, ply_s=ply_s,
        ply_load_s=load_s, raw={"verts": raw_v.shape[0],
                                "faces": raw_f.shape[0]},
        cleaned={"verts": clean_v.shape[0], "faces": clean_f.shape[0]},
        block={"at": lo.tolist(), "size": MESH_BLOCK, "faces": nf.shape[0],
               "native_s": native_s, "numpy_s": numpy_s,
               "max_abs_err": mc_err},
        grid_holds=errs, peak_device_bytes=peak, run_s=runs["mesh"],
        phase_s=time.perf_counter() - t_phase,
        note="iso: --adaptive_iso over threshold 10 (half the sphere's "
             "density of 20), min(max(10, min + std), max - std) of the "
             "grid, so a field whose density scale is not the scene's "
             "still has a surface at it; grid_s: "
             "extract_density_grid's wall time (points formed on the card, "
             "the fp32 kernel, the grid copied to the host); "
             "kernel_device_ms / device_ms: one profiled 512^3 grid; "
             "pack_share: one weight pack over the grid (packed once), "
             "_if_per_call: packed for each of its calls")
    return launches["mesh"]["fused_mlp_fwd"]


def dp_worker(argv) -> int:
    """``chip_smoke.py --dp_worker OUT MODULE ARGS...``, a process of a
    ``torchrun`` launch: runs ``python -m MODULE ARGS`` as that launch
    would run it, the kernels' launch counters set to 0 just before and
    read just after into ``OUT.rank{RANK}.json`` with its seconds, the
    kind of each window its ``graph.Graphs`` ran and their replays."""
    import runpy

    import torch.distributed as dist

    out, module, *args = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.train import graph

    made = []

    class Seen(graph.Graphs):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    graph.Graphs = Seen
    sys.argv = [module] + args
    fused_mlp.launches = fused_mlp.bwd_launches = 0     # path starts
    t = time.perf_counter()
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    rec = {"fused_mlp_fwd": fused_mlp.launches,          # path ends
           "fused_mlp_bwd": fused_mlp.bwd_launches,
           "s": time.perf_counter() - t,
           "windows": _window_kinds(made),
           "replays": sum(g.replays for g in made)}
    with open(f"{out}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(rec, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _torchrun(nproc: int, module: str, argv, out: str) -> dict:
    """``torchrun --standalone --nproc_per_node nproc -m module argv``
    through ``dp_worker`` (its output in ``out.log``): every rank's launch
    counts and seconds, and the launch's wall seconds.  A rank that fails
    fails the launch, which raises; the launch's process group is killed
    at the time limit."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           "--dp_worker", out, module] + list(argv)
    t = time.perf_counter()
    with open(out + ".log", "w") as log_f:
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t
    if rc != 0:
        with open(out + ".log") as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"torchrun {module} {argv}: exit {rc}\n{tail}")
    ranks = {}
    for r in range(nproc):
        with open(f"{out}.rank{r}.json") as f:
            ranks[r] = json.load(f)
    return {"ranks": ranks, "wall_s": wall}


def _files_equal(a: str, b: str) -> list:
    """The names of the files under directory ``a`` whose bytes differ
    from ``b``'s (or that ``b`` lacks)."""
    bad = []
    for name in sorted(os.listdir(a)):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            bad += [f"{name}/{x}" for x in _files_equal(pa, pb)]
            continue
        with open(pa, "rb") as fa:
            same = os.path.exists(pb) and fa.read() == open(pb, "rb").read()
        if not same:
            bad.append(name)
    return bad


def _logged(exp: str) -> dict:
    """metrics.jsonl's records by (step, kind) without their clock fields
    (``ts``, ``steps_per_sec``)."""
    out = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for r in map(json.loads, f):
            rec = {k: v for k, v in r.items()
                   if k not in ("ts", "train/steps_per_sec")}
            out[(r["step"], min(k for k in rec if k != "step"))] = rec
    return out


def _window_ms(exp: str) -> dict:
    """ms per step of each i_print window, from metrics.jsonl."""
    return {k: 1e3 / r["train/steps_per_sec"]
            for k, r in _records(exp, "train/steps_per_sec").items()}


def phase_dp(dev, work):
    """Returns (forward launches, backward launches) of the runs.  ``work``
    as in ``phase_video``, with the export phase's artifacts in
    ``work["serving"]``."""
    import shutil

    from plnerf_torch.cli import extract_mesh

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plnerf_dp_")
    try:
        data, _ = sphere_data(work["scenes"])
        ckpt = os.path.join(root, "ckpt")
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "configs", "blender_linear.txt")

        def where(exp):
            return ["--ckpt_dir", ckpt, "--expname", exp, "--data_dir", data,
                    "--scene_id", "sphere"]

        def commands(exp, extra=(), ft=None):
            """(name, module, argv) of the train, resume, test and mesh
            runs of experiment ``exp``; ``ft``: the checkpoint the test
            and mesh runs evaluate (default the run's own)."""
            train = (["--config", config, "--task", "train"] + where(exp)
                     + DP_TRAIN + list(extra))
            ev = where(exp) + (["--ft_path", ft] if ft else [])
            return [
                ("train", DRIVER, train + ["--num_iterations",
                                           str(DP_STEPS)]),
                ("resume", DRIVER, train + ["--num_iterations",
                                            str(DP_RESUME_STEPS)]),
                ("test", DRIVER, ["--task", "test", "--white_bkgd"] + ev),
                ("mesh", MESH, ev + DP_MESH + [
                    "--mesh_outdir", os.path.join(root, "mesh_" + exp)])]

        # the plain runs, in this process; then the same under torchrun
        run, _, launches, runs = _driver_runs()
        mrun, _, mlaunches, mruns = _driver_runs(extract_mesh.main)
        for name, module, argv in commands("plain"):
            (mrun if module == MESH else run)(name, argv)
        launches.update(mlaunches)
        runs.update(mruns)
        dp1 = {name: _torchrun(1, module, argv,
                               os.path.join(root, f"dp1_{name}"))
               for name, module, argv in commands("dp1")}

        exp = {w: os.path.join(ckpt, w) for w in ("plain", "dp1")}
        checks = {
            "logged": [k for k, v in _logged(exp["plain"]).items()
                       if _logged(exp["dp1"]).get(k) != v],
            "state": {c: _state_diff(*(torch.load(
                os.path.join(exp[w], c), map_location="cpu",
                weights_only=True) for w in ("plain", "dp1")))["tensors"]
                for c in (f"{DP_STEPS:06d}.ckpt",
                          f"{DP_RESUME_STEPS:06d}.ckpt")},
            # the test set, the val render (the checkpoints above)
            "files": [f for f in _files_equal(exp["plain"], exp["dp1"])
                      if f not in ("args.json", "metrics.jsonl")
                      and not f.endswith(".ckpt")],
            "mesh": _files_equal(os.path.join(root, "mesh_plain"),
                                 os.path.join(root, "mesh_dp1")),
            "launches": [n for n, d in dp1.items() if launches[n] != {
                k: d["ranks"][0][k] for k in launches[n]}]}
        if any(checks["state"].values()) or any(
                v for k, v in checks.items() if k != "state"):
            raise AssertionError(f"torchrun (1 rank) against the plain "
                                 f"runs: {checks}")

        # --steps_per_dispatch 8: the windows replayed with their
        # all-reduce inside, in this process and under torchrun
        def train_n(exp, extra=()):
            return (["--config", config, "--task", "train"] + where(exp)
                    + DP_N_TRAIN + list(extra))

        run("train_n8", train_n("plain8"))
        dp8 = _torchrun(1, DRIVER, train_n("dp8"),
                        os.path.join(root, "dp8_train"))
        n8 = _dp_windows(os.path.join(ckpt, "plain8"),
                         os.path.join(ckpt, "dp8"), GRAPH_RUNS["train_n8"],
                         launches["train_n8"], dp8["ranks"])

        launched = {**dp1, "train_n8": dp8}

        w2 = "not run: 1 card"
        if torch.cuda.device_count() >= 2:
            w2 = _dp_two_ranks(commands, ckpt, root, train_n)

        serving = _dp_serving(dev, os.path.join(work["serving"],
                                                "float32_baked"))
        ms = {w: _window_ms(exp[w]) for w in exp}
        log("dp", card=card_line(), recipe="configs/blender_linear.txt",
            steps=DP_RESUME_STEPS, resumed_from=DP_STEPS,
            launcher="torchrun --standalone --nproc_per_node 1 (NCCL)",
            checks=checks, ms_per_step_by_window=ms,
            ms_per_step={w: statistics.mean(
                v for k, v in ms[w].items()
                if k not in (DP_PRINT, DP_STEPS + DP_PRINT)) for w in ms},
            run_s={"plain": runs, "torchrun_wall": {
                n: d["wall_s"] for n, d in dp1.items()},
                "torchrun_rank0": {n: d["ranks"][0]["s"]
                                   for n, d in dp1.items()}},
            launches={"plain": launches, "torchrun": {
                n: {k: v for k, v in d["ranks"][0].items() if k != "s"}
                for n, d in launched.items()}},
            n8=dict(n8, torchrun_wall_s=dp8["wall_s"],
                    plain_run_s=runs["train_n8"]),
            w2=w2, serving=serving,
            phase_s=time.perf_counter() - t_phase,
            note="ms_per_step: the mean of the i_print windows but the "
                 "first of each process (20 and 40; metrics.jsonl's "
                 "steps_per_sec); torchrun_wall "
                 "includes the launcher, the process start and the "
                 "process group's rendezvous; n8: the recipe in bf16 at "
                 "--steps_per_dispatch 8, 40 steps in this process and "
                 "under torchrun (1 rank, NCCL), bit-equal; windows: each "
                 "window's kind (first eager, then captured with its "
                 "all-reduce and replayed); replayed_ms_per_step: the "
                 "print records of steps 17-40, replayed windows only; "
                 "trace: the --profile window 9-16, a replay, its host "
                 "waits, fused kernels and NCCL kernels on the card")
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values()) + sum(
            d["ranks"][0]["fused_mlp_fwd"] for d in launched.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values()) + sum(
            d["ranks"][0]["fused_mlp_bwd"] for d in launched.values())
        return fwd, bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dp_windows(plain: str, dp: str, plain_graphs: dict,
                plain_launches: dict, ranks: dict) -> dict:
    """The N = 8 run in this process (experiment ``plain``) against the
    same run under torchrun (``dp``, its ``ranks``' records): checkpoints,
    logged losses and the val render bit-equal, the wrappers' launches
    equal, every full window but the first replayed in both (rank 0's
    plan read from the launched process), and in each run's traced
    replayed window no host wait and 2 + 2 fused kernels a step counted
    on the card (bf16: one forward kernel per call); raises otherwise."""
    name = f"{DP_N_STEPS:06d}.ckpt"
    traces = {w: _profile_window(os.path.join(d, "profile",
                                              f"trace_{DP_N + 1:06d}.json"),
                                 DP_N)
              for w, d in (("plain", plain), ("torchrun", dp))}
    fused = {k: 2 * DP_N for k in ("bf16_kernel", "data_kernel",
                                   "weight_kernel", "reduce_kernel")}
    r0 = ranks[0]
    checks = {
        "state": _state_diff(*(torch.load(os.path.join(d, name),
                                          map_location="cpu",
                                          weights_only=True)
                               for d in (plain, dp)))["tensors"],
        "logged": [k for k, v in _logged(plain).items()
                   if _logged(dp).get(k) != v],
        "files": [f for f in _files_equal(plain, dp)
                  if f not in ("args.json", "metrics.jsonl")
                  and not f.endswith(".ckpt")
                  and not f.startswith("profile/")],
        "launches": {k: (v, r0[k]) for k, v in plain_launches.items()
                     if r0[k] != v},
        "windows": {w: p for w, p in (("plain", plain_graphs["windows"]),
                                      *((f"rank{r}", d["windows"])
                                        for r, d in ranks.items()))
                    if p != DP_N_PLAN},
        "traces": {w: t for w, t in traces.items()
                   if t["windows"] != 1 or t["syncs"]["per_step"]
                   or t["kernels"] != fused}}
    if any(checks.values()):
        raise AssertionError(f"--steps_per_dispatch {DP_N} under torchrun "
                             f"against the plain run: {checks}")
    return {"windows": DP_N_PLAN,
            "replays": {"plain": plain_graphs["replays"],
                        "torchrun": {r: d["replays"]
                                     for r, d in ranks.items()}},
            "captures_plain": plain_graphs["captures"],
            "capture_s_plain": plain_graphs["capture_s"],
            "replayed_ms_per_step": {
                w: _steady_ms(d, 2 * DP_N)
                for w, d in (("plain", plain), ("torchrun", dp))},
            "trace": {w: {k: t[k] for k in (
                "kernels", "nccl_kernels", "syncs", "busy",
                "host_ms_per_step", "device_ms_per_step")}
                for w, t in traces.items()},
            "launches": {"plain": plain_launches,
                         "torchrun_rank0": {k: r0[k] for k in
                                            plain_launches}},
            "bit_equal": True}


def _params(path: str) -> torch.Tensor:
    """The networks of a checkpoint, flat."""
    s = torch.load(path, map_location="cpu", weights_only=True)
    return torch.cat([t.reshape(-1) for _, t in sorted(_leaves(
        {k: s[k] for k in ("params_coarse", "params_fine")}))])


def _dp_two_ranks(commands, ckpt: str, root: str, train_n) -> dict:
    """World size 2 against world size 1, both under torchrun with perturb
    off: logged losses 1e-6 relative, the final parameters 1e-5 relative
    L2; the test maps and the grid of world size 1's checkpoint bit-equal;
    and the N = 8 run (``train_n``) the same way, every full window but
    the first replayed on each rank (raises otherwise)."""
    out = {}
    for w in (1, 2):
        ft = (None if w == 1 else os.path.join(
            ckpt, "pp1", f"{DP_RESUME_STEPS:06d}.ckpt"))
        for name, module, argv in commands(f"pp{w}", ["--perturb", "0"],
                                           ft):
            out[w, name] = _torchrun(w, module, argv,
                                     os.path.join(root, f"pp{w}_{name}"))
        out[w, "train_n8"] = _torchrun(
            w, DRIVER, train_n(f"pn{w}", ["--perturb", "0"]),
            os.path.join(root, f"pn{w}_train"))
    exp = {w: os.path.join(ckpt, f"pp{w}") for w in (1, 2)}
    exp_n = {w: os.path.join(ckpt, f"pn{w}") for w in (1, 2)}

    def loss_rel(exps):
        losses = [{k: r["train/loss"] for k, r in _records(
            exps[w], "train/loss").items()} for w in (1, 2)]
        return max(abs(losses[1][k] - v) / abs(v)
                   for k, v in losses[0].items())

    params_rel = rel_l2(*(_params(os.path.join(
        exp[w], f"{DP_RESUME_STEPS:06d}.ckpt")) for w in (2, 1)))
    params_rel_n = rel_l2(*(_params(os.path.join(
        exp_n[w], f"{DP_N_STEPS:06d}.ckpt")) for w in (2, 1)))
    test = [d for d in os.listdir(exp[1]) if d.startswith("test_images_")]
    files = _files_equal(os.path.join(exp[1], test[0]),
                         os.path.join(exp[2], test[0]))
    mesh = _files_equal(os.path.join(root, "mesh_pp1"),
                        os.path.join(root, "mesh_pp2"))
    plans = {f"w{w}.rank{r}": d["windows"] for w in (1, 2)
             for r, d in out[w, "train_n8"]["ranks"].items()}
    rec = {"loss_max_rel": loss_rel(exp), "params_rel_l2": params_rel,
           "test_files_differing": files, "mesh_files_differing": mesh,
           "n8": {"loss_max_rel": loss_rel(exp_n),
                  "params_rel_l2": params_rel_n, "windows": plans,
                  "replayed_ms_per_step": {
                      w: _steady_ms(exp_n[w], 2 * DP_N) for w in (1, 2)}},
           "launches_w2": {n: out[2, n]["ranks"] for n in
                           ("train", "resume", "test", "mesh", "train_n8")},
           "ms_per_step": {w: _window_ms(exp[w]) for w in (1, 2)}}
    if (rec["loss_max_rel"] > 1e-6 or params_rel > 1e-5 or files or mesh
            or rec["n8"]["loss_max_rel"] > 1e-6 or params_rel_n > 1e-5
            or any(p != DP_N_PLAN for p in plans.values())):
        raise AssertionError(f"world size 2 against 1: {rec}")
    return rec


def _dp_serving(dev, art: str) -> dict:
    """The export phase's baked fp32 artifact through
    ``ServingRenderer.load(devices=[cuda:0, cuda:0])`` (and [cuda:0,
    cuda:1] where a second card exists): the three 32,768-ray requests
    and one 400x400 image (5 chunks, round-robin) bit-equal to one
    device's chunk path."""
    from plnerf_torch.serving.runtime import ServingRenderer

    one = ServingRenderer.load(art, device=dev)
    one._fused = None
    requests = [_blender_rays(dev, R_CHUNK, seed) for seed in range(3)]
    c2w, K = _blender_camera(7)
    f = K[0, 0] * EXPORT_HW / 800
    c = EXPORT_HW / 2
    K2 = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)

    def serve(srv):
        t = time.perf_counter()
        outs = [srv.render_rays(r, seed=s) for s, r in enumerate(requests)]
        outs.append(srv.render_image(c2w, (EXPORT_HW, EXPORT_HW, f), K2,
                                     seed=0))
        return outs, time.perf_counter() - t

    ref, _ = serve(one)
    sets = [[dev, dev]]
    if torch.cuda.device_count() >= 2:
        sets.append([torch.device("cuda", 0), torch.device("cuda", 1)])
    out = {}
    for devs in sets:
        srv = ServingRenderer.load(art, devices=devs)
        serve(srv)                                          # warm
        got, s = serve(srv)
        bad = [(i, k) for i, (g, r) in enumerate(zip(got, ref))
               for k in r if not np.array_equal(g[k], r[k])]
        if bad or srv._fused is not None:
            raise AssertionError(f"devices {devs}: maps differ {bad}")
        out[",".join(str(d) for d in devs)] = {"bit_equal": True, "s": s}
    if len(sets) == 1:
        out["cuda:0,cuda:1"] = "not run: 1 card"
    return out


# ---------------------------------------------------------------------------
# dispatch: --steps_per_dispatch N, windows in which the host never waits
# ---------------------------------------------------------------------------

# N = 8 against N = 1 for 120 steps of the driver's recipe, its precrop and
# constant quadrature cut to 30 / 60 so that windows split (and the grid's
# warm-up to 40); prints every 8 steps, so both runs print about as often
# and the windows ending at 8, 16, 24 and 120 log in both
DISPATCH_N, DISPATCH_STEPS, DISPATCH_PRINT = 8, 120, 8
DISPATCH_TRAIN = ["--precrop_iters", "30", "--constant_init", "60",
                  "--i_print", str(DISPATCH_PRINT), "--i_weights",
                  str(DISPATCH_STEPS), "--i_img", "1000000",
                  "--i_testset", "1000000", "--i_video", "1000000",
                  "--num_iterations", str(DISPATCH_STEPS)]
DISPATCH_OCC_WARMUP = 40
# a sphere at 100x100: 8 views hold 80,000 rays, 78 full batches an epoch,
# so the pool runs reshuffle inside their 120 steps
DISPATCH_POOL_SIZE = 100
# the depth recipe, 40 steps at N = 4 against N = 1, past its warm start
# and its scale / shift freeze, on the multi-object scene at 100x100
DISPATCH_DEPTH_N, DISPATCH_DEPTH_STEPS, DISPATCH_DEPTH_SIZE = 4, 40, 100
DISPATCH_DEPTH = ["--i_print", "4", "--i_img", "1000000", "--i_weights",
                  str(DISPATCH_DEPTH_STEPS), "--num_iterations",
                  str(DISPATCH_DEPTH_STEPS), "--warm_start_nerf", "10",
                  "--freeze_ss", "20"]
# the print records of steps 84-115 (depth 13-40): at N > 1 only replayed
# windows (76-83 is the last phase's first replay after its capture)
DISPATCH_REPLAYED, DISPATCH_DEPTH_REPLAYED = (83, 115), (12, 40)
# --profile on the N = 8 and N = 1 runs: 8 steps, from the window that
# starts past step 3 (9-16 at N = 8, 4-11 at N = 1)
DISPATCH_PROFILE = 8
# the census: one window of each step flavour at full width, as the
# drivers call them, after a window that builds and warms up
CENSUS_WINDOW = 8
CENSUS_FLAVOURS = ("nvs_fp32", "nvs_bf16", "vanilla_fp32", "pool_fp32",
                   "occ_bf16", "depth_fp32", "depth_occ_fp32")
# the same flavours as the drivers run a full window: one CUDA graph
# (``_graph_flavour``), staged and replayed under the same checks
GRAPH_CENSUS = tuple("graph_" + f for f in CENSUS_FLAVOURS)
# the host's waits per fp32 step before (PERF.md §5: profile_step, PR 5)
PR5_SYNCS_PER_STEP = 13


def _census_scene(dev) -> tuple:
    """(images, poses, K, i_train) of the numpy sphere at 200x200 on the
    card, as the NVS driver holds them."""
    from plnerf_torch.data.synthetic import make_sphere_dataset

    images, poses, hwf, K = make_sphere_dataset(8, 200, 200)
    return (torch.as_tensor(images, device=dev),
            torch.as_tensor(poses[:, :3, :4], device=dev),
            torch.as_tensor(K, device=dev), torch.arange(8, device=dev))


def _flavour_parts(dev, flavour: str, scene: tuple) -> dict:
    """A step flavour as the drivers build it (their ``build_configs``
    on the recipe's flags, the batch made on the card from ``scene``,
    ``_census_scene``): the NVS step (two Adams) in fp32 and bf16, the
    vanilla joint Adam, a pool slice, the grid's step, the depth step
    with camera embeddings (frozen scale / shift from step 4), with and
    without the grid.  {setup, state, grid, depth, batch}: ``batch(g,
    i_batch, img)`` is one step's batch (the pool's rows from ``i_batch``,
    the depth step's image ``img``)."""
    import dataclasses

    from plnerf_torch.cli import config, run_depth, run_plnerf
    from plnerf_torch.core import occgrid
    from plnerf_torch.device import make_generator
    from plnerf_torch.train import batching
    from plnerf_torch.train.step import init_state

    root = os.path.dirname(os.path.abspath(__file__))
    images, poses, K, i_train = scene
    near, far = 2.0, 6.0
    if flavour.startswith("depth"):
        argv = ["train"] + DEPTH_TRAIN + ["--dataset", "blender2_depth",
                                          "--set_near_plane", "2.0",
                                          "--white_bkgd", "--freeze_ss", "4"]
        if flavour == "depth_occ_fp32":
            argv += ["--occ_grid", "--occ_bound", "1.5"]
        args = run_depth.config_parser().parse_args(argv)
        _, rcfg, setup = run_depth.build_configs(args)
        occ_cfg = run_plnerf.occ_cfg_from_args(args)
        if occ_cfg is not None:
            setup = dataclasses.replace(setup, rcfg=dataclasses.replace(
                rcfg, occ=occ_cfg))
        grid = (None if occ_cfg is None else
                occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ_cfg, dev))
        state = init_state(make_generator(0, dev), setup, dev, n_images=8)
        intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).expand(
            8, 4).contiguous()
        depths = torch.full(images.shape[:3], 4.0, device=dev)
        mask = torch.ones(images.shape[:3], device=dev)

        def batch(g, i_batch, img):
            return run_depth.depth_batch(
                images, poses, intr, depths, mask, img, N_RAND, near, far,
                rcfg.use_viewdirs, g)

        return dict(setup=setup, state=state, grid=grid, depth=True,
                    batch=batch)
    cfg = "blender_linear_occ.txt" if flavour == "occ_bf16" \
        else "blender_linear.txt"
    argv = ["--config", os.path.join(root, "configs", cfg)]
    if flavour == "nvs_bf16":
        argv += ["--mlp_dtype", "bfloat16"]
    args = config.config_parser().parse_args(argv)
    _, rcfg, setup = run_plnerf.build_configs(
        args, vanilla=flavour.startswith("vanilla"))
    occ_cfg = run_plnerf.occ_cfg_from_args(args)
    state = init_state(make_generator(0, dev), setup, dev)
    grid = None
    if occ_cfg is not None:
        setup = dataclasses.replace(setup, rcfg=dataclasses.replace(
            rcfg, occ=occ_cfg))
        grid = occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ_cfg, dev)
    pool = None
    if flavour.startswith("pool"):
        pool = torch.as_tensor(batching.build_ray_pool(
            images.cpu().numpy(), poses.cpu().numpy(), K.cpu().numpy(),
            range(8)), device=dev)

    def batch(g, i_batch, img):
        if pool is not None:
            rays, target = batching.pool_batch(pool, i_batch, N_RAND, near,
                                               far, rcfg.use_viewdirs)
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, N_RAND, near, far,
                rcfg.use_viewdirs)
        return {"rays": rays, "target": target}

    return dict(setup=setup, state=state, grid=grid, depth=False,
                batch=batch)


def _flavour(dev, flavour: str, scene: tuple):
    """A closure running one step of ``flavour`` (``_flavour_parts``)
    through the public step functions, as the drivers called them
    before their windows became graphs."""
    from plnerf_torch.device import make_generator
    from plnerf_torch.train.step import (apply_occ_update,
                                         make_depth_train_step,
                                         make_occ_train_step,
                                         make_train_step)

    p = _flavour_parts(dev, flavour, scene)
    setup, state, grid = p["setup"], p["state"], p["grid"]
    occ = setup.rcfg.occ is not None
    step = (make_depth_train_step(setup) if p["depth"] else
            make_occ_train_step(setup) if occ else make_train_step(setup))
    g = make_generator(1, dev)
    rng = np.random.default_rng(0)
    i_batch = 0

    def run():
        nonlocal state, grid, i_batch
        batch = p["batch"](g, i_batch, int(rng.choice(8)))
        i_batch += N_RAND
        if p["depth"] and occ:
            state, m = step(state, dict(batch, occ_grid=grid), g)
            grid, _ = apply_occ_update(setup, grid, batch, m)
        elif p["depth"] or not occ:
            state, _ = step(state, batch, g)
        else:
            state, grid, _ = step(state, grid, batch, g)

    return run


def _graph_flavour(dev, flavour: str, scene: tuple):
    """A closure running one window of ``CENSUS_WINDOW`` steps of
    ``flavour`` (``graph_`` and a name of ``_flavour_parts``) as the
    drivers run it, one CUDA graph (``graph.Graphs``): the first call
    runs it eagerly from the host's values, the second captures and
    replays it, every later call replays it, each of these with the
    host's values staged (``stage_window``) and the batches made on the
    card from the staged offsets and images.  The closure's ``graphs``
    holds the plan."""
    from plnerf_torch.device import make_generator
    from plnerf_torch.train import graph
    from plnerf_torch.train.step import (make_multi_train_step,
                                         stage_window, window_counters)

    p = _flavour_parts(dev, flavour[len("graph_"):], scene)
    state, n = p["state"], CENSUS_WINDOW
    g = make_generator(1, dev)
    multi = make_multi_train_step(p["setup"], n, depth=p["depth"])
    feed = graph.Feed(n, dev, len(state.optimizers()))
    graphs = graph.Graphs(dev, n, window_counters(state), [g])
    rng = np.random.default_rng(0)
    i_batch = 0

    def window():
        nonlocal i_batch
        offsets = range(i_batch, i_batch + n * N_RAND, N_RAND)
        imgs = [int(rng.choice(8)) for _ in range(n)]
        staged = graphs.schedule("window", n) in graph.STAGED
        if staged:
            stage_window(feed, state, n, offset=offsets, img=imgs)
            offsets, imgs = feed.row("offset"), feed.row("img")
        i_batch += n * N_RAND

        def body(m):
            return multi.window(state, m, lambda k: p["batch"](
                g, offsets[k], imgs[k]), g, feed if staged else None,
                p["grid"])

        graphs.prepare("window", body, n)
        return graphs.run("window", body, n)

    window.graphs = graphs
    return window


def _window_spans(trace: dict) -> list:
    """(start, end) us of the trace's ``window`` spans on the host (the
    drivers' windows from their launch; the card's copies of them are
    ``gpu_user_annotation``)."""
    from plnerf_torch.train.graph import WINDOW_SPAN

    return [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
            and e.get("cat") == "user_annotation"]


def _trace_syncs(trace: dict, steps: int, spans) -> dict:
    """The host's waits on the card inside ``spans`` ((start, end) us) of
    a Chrome trace, per step and by op chain
    (``utils/profile.trace_host_syncs``)."""
    from plnerf_torch.utils.profile import trace_host_syncs

    def inside(e):
        ts = e.get("ts")
        return ts is not None and any(a <= ts <= b for a, b in spans)

    chains = trace_host_syncs({"traceEvents": [
        e for e in trace["traceEvents"] if inside(e)]})
    return {"per_step": sum(c for _, c, _ in chains) / steps,
            "chains": [[ch[:160], c / steps, round(ms / steps, 4)]
                       for ch, c, ms in chains]}


def _busy(trace: dict, t0: float, t1: float) -> dict:
    """Device ms (kernels, copies, sets) that start in [t0, t1] us, and
    their share of the span from t0 to the last one's end."""
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and t0 <= e["ts"] <= t1]
    if not spans:
        return {"device_ms": 0.0, "span_ms": 0.0, "busy": None}
    end = max(e["ts"] + e["dur"] for e in spans)
    dev_ms = sum(e["dur"] for e in spans) / 1e3
    span = (end - t0) / 1e3
    return {"device_ms": dev_ms, "span_ms": span, "busy": dev_ms / span}


def _kernel_ms(trace: dict, t0: float, steps: int) -> dict:
    """Device ms per step of each fused-MLP kernel (by short name) that
    starts at or after t0 us in a Chrome trace."""
    from plnerf_torch.utils.profile import FUSED_MLP_KERNELS

    out = {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel" or e["ts"] < t0:
            continue
        m = re.search(FUSED_MLP_KERNELS, e["name"])
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e["dur"] / 1e3 / steps
    return out


def step_census(dev, debug_mode=None,
                flavours=CENSUS_FLAVOURS + GRAPH_CENSUS,
                out_dir=None) -> dict:
    """For each step flavour (``_flavour``, or ``_graph_flavour`` for a
    ``graph_`` one, run after its eager flavour): a window of
    ``CENSUS_WINDOW`` steps that builds and
    warms up (two for a graph: the eager one and the one it is captured
    at), then one under ``torch.cuda.set_sync_debug_mode(debug_mode)``
    (``"error"``: a wait on the card raises; a graph's staging and
    replay), then one under ``torch.profiler``: the host's waits per step
    by op chain, device ms per step, the busy share of the window's wall
    time, the launches the wrappers counted in it (2 + 2 a step eagerly,
    none in a replay) and the fused kernels the card ran in it
    (``utils/profile.trace_kernel_counts``: a replay's the same as the
    eager window's)."""
    from torch.autograd.profiler import record_function

    from plnerf_torch.kernels import fused_mlp
    from plnerf_torch.utils.profile import (end_trace, start_trace,
                                            trace_kernel_counts)

    out = {}
    tmp = out_dir or tempfile.mkdtemp(prefix="plnerf_census_")
    scene = _census_scene(dev)
    for name in flavours:
        if name.startswith("graph_"):
            run = _graph_flavour(dev, name, scene)
            calls, warm = 1, 2
        else:
            run = _flavour(dev, name, scene)
            calls, warm = CENSUS_WINDOW, 1
        for _ in range(warm * calls):
            run()
        torch.cuda.synchronize()
        if debug_mode is not None:
            torch.cuda.set_sync_debug_mode(debug_mode)
            try:
                for _ in range(calls):
                    run()
            except RuntimeError as e:
                raise AssertionError(f"census {name}: the window waited on "
                                     f"the card: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        counted = (fused_mlp.launches, fused_mlp.bwd_launches)
        # the session holds this window only: its kernels are counted
        # whole, not from the span's host start (utils/profile's
        # TRACE_MARGIN_S says why)
        prof = start_trace(dev)
        with record_function("dispatch_window"):
            for _ in range(calls):
                run()
        end_trace(prof, dev)
        path = os.path.join(tmp, f"census_{name}.json")
        prof.export_chrome_trace(path)
        counted = (fused_mlp.launches - counted[0],
                   fused_mlp.bwd_launches - counted[1])
        with open(path) as f:
            trace = json.load(f)
        win = next(e for e in trace["traceEvents"]
                   if e.get("name") == "dispatch_window"
                   and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        # device records stamped early still count, from the first
        first = min((e["ts"] for e in trace["traceEvents"]
                     if e.get("cat") in ("kernel", "gpu_memcpy",
                                         "gpu_memset")), default=t0)
        busy = _busy(trace, min(t0, first), float("inf"))
        kernels = trace_kernel_counts(trace)
        out[name] = {"syncs": _trace_syncs(trace, CENSUS_WINDOW, [(t0, t1)]),
                     "host_ms_per_step": win["dur"] / 1e3 / CENSUS_WINDOW,
                     "device_ms_per_step": busy["device_ms"] / CENSUS_WINDOW,
                     "busy": busy["busy"], "launches": counted,
                     "traced_kernels": kernels,
                     "kernel_ms_per_step": _kernel_ms(trace, min(t0, first),
                                                      CENSUS_WINDOW)}
        # the eager window: the wrappers count 2 + 2 launches a step; the
        # replay, which they do not see, runs the same fused kernels
        eager = out.get(name[len("graph_"):]) if name.startswith(
            "graph_") else out[name]
        want = (0, 0) if name.startswith("graph_") else (
            2 * CENSUS_WINDOW, 2 * CENSUS_WINDOW)
        if (eager is None or counted != want
                or kernels.get("weight_kernel") != 2 * CENSUS_WINDOW
                or kernels != eager["traced_kernels"]):
            raise AssertionError(
                f"census {name}: {counted} launches counted, fused kernels "
                f"traced {kernels} (eager: "
                f"{eager and eager['traced_kernels']})")
        if hasattr(run, "graphs"):
            plan = [k for _, _, k in run.graphs.windows()]
            if plan != ["first", "capture"] + ["replay"] * (len(plan) - 2):
                raise AssertionError(f"census {name}: windows {plan}")
            out[name]["windows"] = plan
    return out


def _profile_window(path: str, steps: int) -> dict:
    """A driver's ``--profile`` trace of ``steps`` steps: its
    ``window`` spans, the fused kernels the card ran
    (``utils/profile.trace_kernel_counts``), the host's waits inside the
    spans per step, the device's busy share from the first launch, device
    and host ms per step, its gaps and its NCCL kernels."""
    from plnerf_torch.utils.profile import (trace_device_gaps,
                                            trace_kernel_counts)

    with open(path) as f:
        tr = json.load(f)
    first_launch = min((e["ts"] for e in tr["traceEvents"]
                        if e.get("cat") == "cuda_runtime"
                        and "Launch" in e.get("name", "")), default=0.0)
    spans = _window_spans(tr)
    busy = _busy(tr, first_launch, float("inf"))
    return {"steps": steps, "windows": len(spans),
            "kernels": trace_kernel_counts(tr),
            "syncs": _trace_syncs(tr, steps, spans), "busy": busy["busy"],
            "device_ms_per_step": busy["device_ms"] / steps,
            "host_ms_per_step": sum(b - a for a, b in spans) / 1e3 / steps,
            "gaps": trace_device_gaps(tr),
            "nccl_kernels": sum(1 for e in tr["traceEvents"]
                                if e.get("cat") == "kernel"
                                and "nccl" in e.get("name", "").lower())}


def _steady_ms(exp: str, after: int, until: float = float("inf")) -> float:
    """ms per step of a driver run from its print records past step
    ``after`` up to ``until``: each covers the steps since the previous
    print, at its ``steps_per_sec``."""
    recs = _records(exp, "train/steps_per_sec")
    steps = sorted(recs)
    t = n = 0.0
    for prev, k in zip(steps, steps[1:]):
        if prev >= after and k <= until:
            t += (k - prev) / recs[k]["train/steps_per_sec"]
            n += k - prev
    return 1e3 * t / n


def _pair(exp1: str, expn: str, steps: int) -> dict:
    """The N = 1 and N > 1 runs' final checkpoints (and sidecars) and
    their losses at the steps both logged: counts of what differs and the
    largest differences; bit-equal expected."""
    name = f"{steps:06d}"
    out = {"state": _state_diff(
        torch.load(os.path.join(exp1, name + ".ckpt"), weights_only=False),
        torch.load(os.path.join(expn, name + ".ckpt"), weights_only=False))}
    occ = os.path.join(exp1, name + ".occ")
    if os.path.exists(occ):
        out["grid"] = _state_diff(
            torch.load(occ, weights_only=True),
            torch.load(os.path.join(expn, name + ".occ"), weights_only=True))
    r1, rn = _records(exp1, "train/loss"), _records(expn, "train/loss")
    shared = sorted(set(r1) & set(rn))
    out["shared_logged_steps"] = shared
    out["loss_max_abs"] = max(abs(r1[k]["train/loss"] - rn[k]["train/loss"])
                              for k in shared)
    out["logged_steps_n"] = sorted(rn)
    if (out["state"]["tensors"] or out.get("grid", {}).get("tensors")
            or out["loss_max_abs"] != 0.0 or steps not in shared):
        raise AssertionError(f"{expn}: N changed a number: {out}")
    return out


def phase_dispatch(dev, work):
    """Returns (forward launches, backward launches) of the driver runs
    of ``--steps_per_dispatch`` N against N = 1.  ``work['scenes']``: the
    driver phases' sphere (written here when missing)."""
    import shutil

    from plnerf_torch.cli import run_depth
    from plnerf_torch.data.synthetic import (write_blender2_depth_scene,
                                             write_sphere_scene)

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plnerf_dispatch_")
    try:
        t0 = time.perf_counter()
        data, _ = sphere_data(work["scenes"])
        write_sphere_scene(os.path.join(root, "pool"), DISPATCH_POOL_SIZE,
                           DRIVER_VIEWS)
        write_blender2_depth_scene(
            os.path.join(root, "mobj"), DEPTH_VIEWS, DISPATCH_DEPTH_SIZE,
            DISPATCH_DEPTH_SIZE, LEGO_CAMERA_ANGLE_X, seed=0,
            workers=min(8, os.cpu_count() or 1))
        scene_s = time.perf_counter() - t0
        t_runs = time.perf_counter()
        census = step_census(dev, "error", out_dir=root)
        census_s = time.perf_counter() - t_runs
        bad = {k: v["syncs"] for k, v in census.items()
               if v["syncs"]["per_step"]}
        if bad:
            raise AssertionError(f"census: waits inside a window: {bad}")

        configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs")
        pool_cfg = os.path.join(root, "blender_linear_batching.txt")
        with open(os.path.join(configs, "blender_linear.txt")) as f, \
                open(pool_cfg, "w") as g:
            g.writelines(l for l in f if not l.startswith("no_batching"))
        ckpt = os.path.join(root, "ckpt")
        prof = ["--profile", str(DISPATCH_PROFILE)]
        recipes = {
            "fp32": (os.path.join(configs, "blender_linear.txt"), data,
                     "sphere", prof),
            "pool_fp32": (pool_cfg, root, "pool", []),
            "bf16": (os.path.join(configs, "blender_linear.txt"), data,
                     "sphere", prof + ["--mlp_dtype", "bfloat16"]),
            "occ_bf16": (os.path.join(configs, "blender_linear_occ.txt"),
                         data, "sphere", prof + [
                             "--occ_warmup", str(DISPATCH_OCC_WARMUP)]),
        }
        run, expect, launches, runs = _driver_runs()
        pairs, ms, replayed_ms, traces = {}, {}, {}, {}
        for name, (cfg, data_dir, scene, extra) in recipes.items():
            for n in (1, DISPATCH_N):
                exp = f"{name}_n{n}"
                run(exp, ["--config", cfg, "--task", "train", "--ckpt_dir",
                          ckpt, "--expname", exp, "--data_dir", data_dir,
                          "--scene_id", scene, "--steps_per_dispatch",
                          str(n)] + DISPATCH_TRAIN + extra)
                # the wrappers count the eager windows' launches: all of
                # N = 1, each phase's first and the short ones at N = 8
                eager = GRAPH_RUNS[exp]["eager_steps"]
                if (eager == DISPATCH_STEPS) != (n == 1):
                    raise AssertionError(f"{exp}: {eager} eager steps")
                expect(exp, 2 * eager, 2 * eager)
                ms[exp] = _steady_ms(os.path.join(ckpt, exp), 24)
                replayed_ms[exp] = _steady_ms(os.path.join(ckpt, exp),
                                              *DISPATCH_REPLAYED)
                if extra[:1] == ["--profile"]:
                    first = 1 + (DISPATCH_N if n > 1 else 3)
                    traces[exp] = _profile_window(os.path.join(
                        ckpt, exp, "profile", f"trace_{first:06d}.json"),
                        DISPATCH_PROFILE)
                    # at N = 8 the traced window (9-16) is a replay: the
                    # card ran in it the fused kernels of the N = 1 run's
                    # eager steps 4-11 (the same phases), whose wrappers
                    # counted 2 + 2 a step
                    kern = traces[exp]["kernels"]
                    if (traces[exp]["windows"]
                            != (1 if n > 1 else DISPATCH_PROFILE)
                            or traces[exp]["syncs"]["per_step"]
                            or kern.get("weight_kernel")
                            != 2 * DISPATCH_PROFILE
                            or kern != traces[f"{name}_n1"]["kernels"]):
                        raise AssertionError(
                            f"{exp}: waits or launches inside the traced "
                            f"windows: {traces[exp]}")
            pairs[name] = _pair(os.path.join(ckpt, f"{name}_n1"),
                                os.path.join(ckpt, f"{name}_n{DISPATCH_N}"),
                                DISPATCH_STEPS)

        drun, dexpect, dlaunches, druns = _driver_runs(run_depth.main)
        for n in (1, DISPATCH_DEPTH_N):
            exp = f"depth_n{n}"
            drun(exp, ["train"] + DEPTH_TRAIN + DISPATCH_DEPTH + [
                "--ckpt_dir", ckpt, "--expname", exp, "--data_dir", root,
                "--scene_id", "mobj", "--dataset", "blender2_depth",
                "--set_near_plane", "2.0", "--white_bkgd",
                "--steps_per_dispatch", str(n)])
            eager = GRAPH_RUNS[exp]["eager_steps"]
            if (eager == DISPATCH_DEPTH_STEPS) != (n == 1):
                raise AssertionError(f"{exp}: {eager} eager steps")
            dexpect(exp, 2 * eager, 2 * eager)
            ms[exp] = _steady_ms(os.path.join(ckpt, exp), 8)
            replayed_ms[exp] = _steady_ms(os.path.join(ckpt, exp),
                                          *DISPATCH_DEPTH_REPLAYED)
        pairs["depth"] = _pair(
            os.path.join(ckpt, "depth_n1"),
            os.path.join(ckpt, f"depth_n{DISPATCH_DEPTH_N}"),
            DISPATCH_DEPTH_STEPS)
        launches.update(dlaunches)
        runs.update(druns)
        # the N > 1 runs replay every full window but each phase's first
        # (eager) and second (captured, then replayed); N = 1 runs none
        graphs = {exp: GRAPH_RUNS[exp] for exp in runs}
        for exp, gr in graphs.items():
            if exp.endswith("_n1") != (gr["captures"] == gr["replays"] == 0):
                raise AssertionError(f"{exp}: graphs {gr}")
            if not exp.endswith("_n1") and gr["replays"] < gr["captures"]:
                raise AssertionError(f"{exp}: graphs {gr}")
        recipes_ms = {exp: {
            **graphs[exp], "driver_ms_per_step": ms.get(exp),
            "replayed_ms_per_step": replayed_ms.get(exp),
            **{k: traces[exp][k] for k in ("host_ms_per_step",
                                           "device_ms_per_step", "busy")
               if exp in traces}} for exp in runs}
        fwd = sum(v["fused_mlp_fwd"] for v in launches.values())
        bwd = sum(v["fused_mlp_bwd"] for v in launches.values())
        log("dispatch", card=card_line(), n=DISPATCH_N,
            depth_n=DISPATCH_DEPTH_N, steps=DISPATCH_STEPS,
            depth_steps=DISPATCH_DEPTH_STEPS, bit_equal=pairs,
            census={k: {"syncs_per_step": v["syncs"]["per_step"],
                        "host_ms_per_step": v["host_ms_per_step"],
                        "device_ms_per_step": v["device_ms_per_step"],
                        "busy": v["busy"], "windows": v.get("windows"),
                        "launches": v["launches"],
                        "traced_kernels": v["traced_kernels"],
                        "kernel_ms_per_step": v["kernel_ms_per_step"]}
                    for k, v in census.items()},
            bf16_backward_ms_per_step_pr11=PR11_BF16_BWD_MS,
            recipes=recipes_ms,
            syncs_per_step_pr5=PR5_SYNCS_PER_STEP,
            traces=traces, ms_per_step=ms, launches=launches,
            launches_per_train_step={"fused_mlp_fwd": 2, "fused_mlp_bwd": 2},
            eager_steps={exp: GRAPH_RUNS[exp]["eager_steps"]
                         for exp in runs},
            run_s=runs, scene_s=scene_s, census_s=census_s,
            phase_s=time.perf_counter() - t_phase,
            runs_s=time.perf_counter() - t_runs,
            note="bit_equal: the final checkpoints (and grids) of N = 1 "
                 "and N > 1, and their losses at the steps both logged; "
                 "launches: the wrappers' counts, 2 + 2 per eagerly run "
                 "step (eager_steps; a graph's replays launch nothing from "
                 "Python); traced_kernels / traces.kernels: the fused "
                 "kernels the card ran in a traced window (census: one "
                 "window; traces: the --profile window, a replay at N = "
                 "8), a replay's equal to the eager window's, whose "
                 "wrappers counted 2 + 2 a step (one weight_kernel per "
                 "backward call, one bf16_kernel per bf16 forward call); "
                 "census: one window of each step flavour under "
                 "set_sync_debug_mode('error') and then traced "
                 "(syncs: the host's waits on the card per step); traces: "
                 "the drivers' --profile windows (syncs inside their "
                 "window spans, busy: device time over the span "
                 "from the first launch); ms_per_step: the print records "
                 "past step 24 (warm-up and the profiled window excluded), "
                 "val renders off; recipes: per run its graphs' captures "
                 "and replays (N > 1: every full window a replay but each "
                 "phase's first) and the captures' host s, driver ms per "
                 "step (ms_per_step; "
                 "replayed_ms_per_step: the records of steps 84-115, depth "
                 "13-40, only replayed windows at N > 1), and "
                 "from the profiled window host and device ms per step and "
                 "the busy share; census graph_*: one window as one CUDA "
                 "graph, staged and replayed under the same checks; "
                 "kernel_ms_per_step: the fused kernels' device ms per "
                 "step in the census window (data_kernel / weight_kernel: "
                 "the backward's data and weight passes), beside PR 11's "
                 "profiled bf16 step (bf16_backward_ms_per_step_pr11)")
        return fwd, bwd
    finally:
        shutil.rmtree(root, ignore_errors=True)


PHASES = ("kernel", "probes", "bwd", "slice", "reference", "export",
          "train", "interop", "train_reference", "driver", "llff", "jpeg",
          "depth", "occ", "video", "mesh", "dp", "dispatch")
# the phases each phase reads the checkpoints (interop: the state; dp:
# the artifacts) of
NEEDS = {"video": ("driver", "depth"), "mesh": ("driver",),
         "interop": ("train",), "dp": ("export",)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated phases out of " + ", ".join(PHASES)
                    + " (env always runs): their lines only, no result "
                    "lines")
    ap.add_argument("--dp_worker", nargs=argparse.REMAINDER,
                    help="OUT MODULE ARGS...: one process of the dp "
                    "phase's torchrun launches (dp_worker)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    if only and not set(only) <= set(PHASES):
        ap.error(f"--only takes {', '.join(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import plnerf_torch  # noqa: F401
        from plnerf_torch.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the plnerf_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    try:
        dev = resolve_device(None)
        phase_env()
        # the driver and occ phases share one sphere scene; the video and
        # mesh phases read the driver and depth phases' checkpoints
        with tempfile.TemporaryDirectory(prefix="plnerf_work_") as tmp:
            work = {k: os.path.join(tmp, k)
                    for k in ("scenes", "driver", "depth", "serving")}
            for d in work.values():
                os.makedirs(d)
            kept = {}
            if only:
                fns = dict(zip(PHASES, (
                    phase_kernel, phase_probes, phase_bwd_kernel,
                    phase_slice, phase_reference,
                    lambda d: phase_export(d, work["serving"]),
                    lambda d: phase_train(d, kept),
                    lambda d: phase_interop(d, kept["state"]),
                    phase_train_reference,
                    lambda d: phase_driver(d, None, work["scenes"],
                                           work["driver"]),
                    phase_llff, phase_jpeg,
                    lambda d: phase_depth(d, work["depth"]),
                    lambda d: phase_occ(d, work["scenes"]),
                    lambda d: phase_video(d, work),
                    lambda d: phase_mesh(d, work),
                    lambda d: phase_dp(d, work),
                    lambda d: phase_dispatch(d, work))))
                need = set(only).union(*(NEEDS.get(n, ()) for n in only))
                for name in PHASES:
                    if name in need:
                        fns[name](dev)
                return 0
            err, t = phase_kernel(dev)
            probe_launches, probe_fwd, probe_entries = phase_probes(dev)
            bwd_err, bwd_t = phase_bwd_kernel(dev)
            launches = phase_slice(dev)
            phase_reference(dev)
            export_fwd = phase_export(dev, work["serving"])
            train_fwd, train_bwd, train_summary = phase_train(dev, kept)
            phase_interop(dev, kept.pop("state"))
            phase_train_reference(dev)
            driver_fwd, driver_bwd = phase_driver(
                dev, train_summary["ms_per_step_fp32"], work["scenes"],
                work["driver"])
            occ_fwd, occ_bwd = phase_occ(dev, work["scenes"])
            llff_fwd, llff_bwd = phase_llff(dev)
            jpeg_fwd, jpeg_bwd = phase_jpeg(dev)
            depth_fwd, depth_bwd = phase_depth(dev, work["depth"])
            video_fwd, video_bwd = phase_video(dev, work)
            mesh_fwd = phase_mesh(dev, work)
            dp_fwd, dp_bwd = phase_dp(dev, work)
            dispatch_fwd, dispatch_bwd = phase_dispatch(dev, work)
    except Exception:
        traceback.print_exc()
        return 1
    if (launches < 1 or train_fwd < 1 or train_bwd < 1 or probe_fwd < 1
            or min(probe_launches.values()) < 1 or driver_fwd < 1
            or driver_bwd < 1 or llff_fwd < 1 or llff_bwd < 1
            or jpeg_fwd < 1 or jpeg_bwd < 1
            or depth_fwd < 1 or depth_bwd < 1 or occ_fwd < 1
            or occ_bwd < 1 or video_fwd < 1 or video_bwd < 1
            or mesh_fwd < 1 or export_fwd < 1 or dp_fwd < 1 or dp_bwd < 1
            or dispatch_fwd < 1 or dispatch_bwd < 1):
        print("chip_smoke: a main path launched no kernel", file=sys.stderr)
        return 1
    # the training path runs folded heads in fp32
    bt = bwd_t["folded_float32"]
    print(json.dumps({"kernels": [{
        "name": "fused_mlp_fwd", "route": "cuda",
        "source": "plnerf_torch/kernels/csrc/fused_mlp_fwd.cu",
        "replaces": KERNEL_REPLACES,
        "launches": (launches + train_fwd + probe_fwd + driver_fwd
                     + llff_fwd + jpeg_fwd + depth_fwd + occ_fwd + video_fwd
                     + mesh_fwd + export_fwd + dp_fwd + dispatch_fwd),
        "max_abs_err": err, "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}, {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "plnerf_torch/kernels/csrc/fused_mlp_bwd.cu",
        "replaces": BWD_REPLACES,
        "launches": (train_bwd + driver_bwd + llff_bwd + jpeg_bwd
                     + depth_bwd + occ_bwd + video_bwd + dp_bwd
                     + dispatch_bwd),
        "max_abs_err": bwd_err, "ms": bt["kernel_ms"],
        "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"],
        "bound_by": bt["bound_by"], "library_ms": bt["library_ms"]}]
        + probe_entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
