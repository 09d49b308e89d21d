#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line; each
prints its seconds (`phase <name>: N s`) and the run its total:
  1. the card's name and power limit (nvidia-smi); a CUDA device is required;
  2. build kernels K1/K3 (ProbSparse window attention on the CUDA cores,
     forward and backward, one source), K1's and K3-v3's tensor-core
     forward and backward (one source) and K2 (fused LN+LeFF) from
     dehaze_tpu_torch/csrc/, one nvcc per source, all at once, for sm_90a,
     and the PNG unfilter and JPEG decoder (host C) beside them; while
     they build, the synthetic data of the later phases is written and
     phase 15a (FFA-Net and the UNet, which need no kernel) runs;
  2b. the image codec on the host: a 1200×1600 textured frame through the
     port's PNG encoder (per-row filters) and decoder, and as a 24-bit BMP,
     each against the pixels; the committed JPEG fixtures (tests/data/)
     against the SHA-256 of cv2's decode of each; encode and decode ms,
     the 1200×1600 JPEG's among them;
  3. K1 forward against its plain twin at the nine stages of the serving
     frame, N = 16, the training enc0 and 16×16 windows (N = 256), f32
     and bf16 (at N <= 64 bf16 runs the tensor-core kernel and f32 K1's
     float32 kernel, N = 256 the CUDA-core one), in bf16 with q and k at
     std 0.5 and 2, 0 rows flipped between a2 @ V and mean(V), each call
     counted on its kernel; then with padding flags at the
     any-resolution shapes of a 1200×1600 frame on the 1664² canvas (enc0
     shifted, bottleneck), and the backward with padding at the training
     enc0 shape;
  4. K1 backward against its plain twin at the training path's shapes
     (batch 32 × 128²: enc0, enc1, bottleneck, dec3), f32 (the CUDA-core
     kernel) and bf16 (the tensor-core kernel, q and k at std 0.5 and 2,
     0 flipped rows: dq is exactly zero on the twin's unselected rows and
     only there), and at 16×16 windows (N = 256, the CUDA-core kernel);
     first a float32 train step's attention at enc0 and dec3 through
     autograd (K1's float32 forward kernel, then the CUDA-core backward):
     gradients against the twin's, 0 flipped rows in the forward's output
     and in dq, so both passes keep the same rows;
  5. K3 (the older TPU variants, which round at other points) against
     their twins: v1 and v2 head-major at the serving enc1 and bottleneck
     shapes (CUDA-core kernel), the v3 forward and backward at the
     training enc0 and enc1 shapes, f32 (CUDA-core kernels) and bf16
     (tensor-core kernels, q and k at std 0.5, 1 and 2, and with padding
     flags; 0 flipped rows), each call checked to reach the kernel its
     chooser names by that kernel's launch counter; in bf16 each K1 and K3
     case is also held to its own rounding points (NUMERICS_SEP);
  6. K2 against its plain twin at the serving path's shapes (rect canvas),
     the evaluation path's (1664² square canvas, 1536² any-resolution),
     the training eval forward's (batch 32 × 128²) and the 76-row
     bottleneck of a 1216×1664 canvas (--train_ps 64), f32 and bf16,
     exact and tanh GELU; the other seven stages of the serving frame
     (K2_STAGES) in bf16 and f32 with exact GELU (f32 on the 3xTF32
     classes); the planner's shared-memory count against the kernel's at
     every C;
  7. a seeded random-init Uformer-32 saved as a .pth state_dict:
     (a) CUDA forward (kernels) against the CPU forward (plain twins) at
         256², f32, same sampling seed; (b) the 1200×1600 uint8 frame
         through the whole-image function (rect canvas 1280×1664, bf16)
         and a profile of one such frame;
         (c) a 200×240 image with its padding mask on the 256² canvas,
         CUDA against CPU, f32 (18 launches of K1's float32 kernel);
         (d) the 1200×1600 frame in f32 (phase_frame_f32): s/frame, 18
         launches each of K1's float32 forward and of K2, nothing else and
         no twin call;
  8. the serving path: the serving CLI's machinery in-process with
     --weights, three PNG requests of synthetic hazy scenes (two
     concurrent) and /healthz;
  9. the evaluation path: `cli.test_long` (square canvas, then
     --rect_canvas) and `cli.test_anyres`, one after another in a
     subprocess (the CLIs of a phase share one process, each run with its
     counts from 0: `_counted_clis`), on synthetic 1200×1600 pairs (and
     one 1000×1500 for any-resolution), Uformer-32 bf16: s/frame,
     launches per frame, peak memory, and each per-image PSNR against the
     in-process function;
  9a. --act_store (phase_k2_actstore): K2 with act_store fp8 and int8
     against its twin at the serving frame's enc0, dec3, enc2, enc3 and
     bottleneck (bf16: int8 in one pass, two sweeps and three sweeps) and
     enc0 and dec0 (f32): max error, share beyond K2_TOL, steps of the
     quantizer beyond it (ACT_SHARE; f32 int8 at dec0 against the twin's
     own share, ACT_SHARE_BY_CHAIN); fp8 NaN cases (LN outputs at 448, 464, 466 and
     a sparse 500: the kernel's NaNs are the twin's); the 1200×1600 frame
     with act_store None, fp8 and int8 (s/frame, 18 K1 and 18 K2 launches
     and no twin call per frame, PSNR against the plain frame);
     `cli.test_long --rect_canvas --act_store int8` (per-image PSNR
     against the in-process forward); then phase_k2_trips: K2's fp8
     device function against `compress(·, "fp8")` on every bf16 and every
     float32 bit pattern, and its int8 one on every bf16 value and amax,
     NaN for NaN and bit for bit elsewhere;
  9b. the parity gate: `cli.parity_gate` on the seeded .pth and the three
     1200×1600 pairs, once with the in-process mean PSNR expected (--tol
     1e-3; exit 0), once 1 dB off (exit 1): s/frame and launches per
     frame;
  9c. the serving slice (phase_serving): `cli.export` on the card and an
     artifact traced on the CPU, each loaded onto the card and equal to
     the eager CUDA forward bit for bit (18 K1 tensor-core and 18 K2
     launches per frame, no twin call); `cli.stream` with --weights on
     STREAM_FRAMES 1200×1600 frames and one 1000×1500, then --exported,
     each output equal to the in-process forward, with the stream's
     s/frame and its stages' ms; `cli.test_long --exported` on that
     rect artifact (PSNRs as --weights --rect_canvas) and on a square
     one from `cli.export --square` (PSNRs as --weights); `serve
     --exported` (200 at the baked geometry, 400 at another);
 10. Uformer-32 at batch 2 × 128², f32, CUDA (kernels) against CPU
     (twins): the model's backward for one fixed output gradient, then one
     train step with the CR loss on a random VGG19 (loss and every
     gradient leaf);
 11. the training path: `python -m dehaze_tpu_torch.cli.train` semantics
     in a subprocess on synthetic pairs, Uformer-32, batch 32 × 128², bf16,
     CR on, one epoch of 8 steps with 4 evals; losses, launch counts per
     step, checkpoints, reload of model_best.pth, img/s and peak memory;
 11b. the device-resident training set: every batch of an epoch gathered
     on the card equal to the streaming pipeline's bit for bit, then
     `cli.train --device_data` with --vgg_weights from `cli.convert_vgg`,
     held as 11 and its img/s and peak memory beside 11's;
 11c. --remat: one full-width train step (bf16, CR on, drop_path 0.1)
     with and without it from the same state: gradients (REMAT_TOL),
     generator states, 36 against 18 K1 forward launches, step ms and
     peak memory;
 11d. the analysis stack (phase_analysis, run after 11): `cli.landscape`
     on Uformer-32 (bf16, CR on the random VGG19, a 3×3 grid of 2 batches
     of 32 × 128²) serially and with --points_per_batch 3 (the same CSV
     byte for byte; 18 K1 and 18 K2 launches per point and batch, no
     twin), on FFA-Net (no launch), `cli.landscape_pair`, and with
     --data_axis 2 on two gloo ranks (the serial CSV); `cli.train` for 3
     short epochs, `cli.archive_params` and `cli.trajectory`;
     `cli.params_flops`, `cli.monitor`, `cli.generate_patches`; the (0, 0)
     loss in f32 on the card against the CPU, and one point × batch timed
     for Uformer-32 and FFA-Net; figures only where matplotlib is
     installed;
 12. the full-width train step with its batches in memory (ms/step, the
     host's ms to queue it, the calls in it that wait for the card), the
     data pipeline alone (ms/batch), and torch.profiler over two steady
     steps: device time by kernel group, the top kernels, the idle share;
 13. the W-MSA Uformer-32 (`attention='full'`, phase_wmsa): f32 CUDA
     against CPU for 'linear'+'leff', 'conv'+'ffn'+SE and
     'linear_concat'+'leff'; the 1200×1600 frame in bf16 (18 K2 and 0 K1
     launches per frame, no twin call; the attention alone at the frame's
     shapes; a profile); `cli.parity_gate --attention full`, `cli.export
     --square` and `cli.test_long --exported`; `cli.train --attention full`
     for 4 steps at batch 32 × 128²;
 14. the multi-GPU paths on the one card (phase_multi): two ranks that
     share it over gloo (NCCL refuses two ranks on one device) run the
     1200×1600 frame in 2 row bands (infer.halo_sharded; bf16 and f32
     against the one-process frame; 18 K1 forward launches per band, no
     K2, no twin call) and 4 DDP steps at 2 × 16 × 128² (CR on, MixUp on
     every other step), held to one NCCL rank's steps at 32 rows; the NCCL
     rank's plain step against its DDP step in turns; `cli.test_long
     --data_axis 2` (two gloo ranks; the one-process PSNRs) and
     `cli.train --data_axis 1` (one NCCL rank); the gloo ranks also run
     FFA-Net's native frame in 2 bands (bf16 and f32 against the
     one-process frame). Two ranks on one card measure no multi-GPU
     speed;
 15. FFA-Net (full width and depth) and the UNet-32, seeded weights:
     (a, during the build) FFA-Net f32 CUDA against CPU on a small frame,
     the 1200×1600 native frame in bf16 and f32 (ms, peak memory, bound,
     a profile with the NCHW<->NHWC copies' share), the UNet frame on the
     rect canvas; (b) `cli.test_long --arch ffa`, `cli.export --arch ffa`
     (its native artifact bit for bit the eager forward) and `test_long
     --exported`, `cli.stream --arch ffa`, a `serve --arch ffa` request;
     (c) `cli.ffa_train` at batch 2 × 240² with --perloss, its
     ffa_best.pk reloaded strictly; (d) `test_long --arch ffa --bands 2`
     on two gloo ranks (the banded frame itself is held in 14); (e)
     `cli.train --arch unet` and `test_long --arch unet`: each path with
     0 launches of every kernel and 0 twin calls. The runs of (b)-(e)
     need no kernel and run while the kernels build (phase_ffa_runs);
     their checks come last (phase_ffa);
 17. the zoo and JAX checkpoints (phase_zoo): 17 zoo models at their
     published sizes on 32² (ZOO_MODELS), seeded, eval mode: f32 logits on
     the card against the CPU (MODEL_TOL; the MC-dropout model with the
     same CPU generator on both sides), then a batch of 128 in bf16 and f32
     (ms, images/s, peak memory), with 0 launches of every kernel; the
     committed `.msgpack` fixture (tests/data/uformer_e4_bf16) read on this
     host, which has no flax or msgpack, and held to its SHA-256s, a
     Uformer-32 checkpoint in flax's format read back and timed, and
     `cli.test_long` with --weights the fixture and its `.pth`: the same
     per-image PSNRs, K1 and K2 launched;
 17b. the zoo's evaluation harness (phase_zoo_harness): ResNet-18 and
     ViT-Ti (seeded, 32², f32, TF32 off) on the card against the CPU:
     `evaluate.test`, `test_perturbation`, the attacks' input gradient
     (signs where |g| > 1e-4·max|g|), FGSM and 10-step PGD, and the
     MC-dropout ResNet-18's `evaluate.test` at n_ff = 4; every
     `cli.zoo` subcommand but `train` in one subprocess on seeded CIFAR-10
     pickles, CIFAR-10-C/-P `.npy` files and a PNG ImageFolder, each
     output held to this process's run on the card in the CLI's mode
     (cuDNN TF32 on); the harness's and the forward's ms per batch of 128
     over a 10,000-row stream (3 passes: median and spread), and
     `predtime` img/s in bf16 and f32 (TF32 convolutions); no kernel
     launched;
 17c. the zoo trainer (phase_zoo_train), on 17b's pickles (2,560
     training rows): ResNet-18 (SGD, weight decay, max_norm) and ViT-Ti
     4×4 (AdamW, smoothing 0.1, max_norm), 3 ZooTrainer steps at batch
     128 with augment and mixup on the card against the CPU (f32, TF32
     off, the same weights and draws: losses, the update, the BN
     statistics); `cli.zoo train` in a subprocess (ViT-Ti bf16, AdamW,
     cosine, 1 warmup epoch and 1 epoch, mixup, smoothing 0.1, --max_norm
     1), its `.pth.tar` files and `cli.zoo eval --ckpt best.pth.tar` at
     the accuracy it printed; `--data_axis 2` as two gloo ranks on the
     card and `--data_axis 1` as one NCCL rank (ResNet-18, SGD, one epoch
     with augment and mixup) against the one-process run; ms per step at
     batch 128 in bf16 and f32 (median of 3 windows of 20 by CUDA events,
     the host's ms to queue one, peak memory, a profile with the idle
     share); no kernel launched;
 18. the kernels' JSON line, then the device's JSON line.
The launch counts in the kernels line are those of the serving path (8),
9a's paths for the two --act_store rows (its frames and `test_long`),
the evaluation path (9, the three runs together), the parity gate (9b,
both runs), the stream with --weights and with --exported, the exported
evaluation (rect and square artifacts) and the exported server (9c), the training path (11), the
device-resident training path (11b), the remat train step (11c), the
analysis stack (11d: the three Uformer-32 sweeps together as `landscape`,
FFA-Net's sweep, `params_flops` and the trajectory's training run) and the
W-MSA paths (13: its frames, its gate, its exported evaluation, its
training run), the float32 frame (7d, the only path of the float32
kernels' rows: K1's float32 forward and K2's 3xTF32 classes), the multi-GPU paths (14: the banded frames over both
ranks, the Uformer's and FFA-Net's, the frame-parallel evaluation over both ranks, the gloo DDP steps
over both ranks, the NCCL rank's DDP steps, the NCCL `cli.train`) and
the FFA-Net and UNet paths (15: frames, evaluation, artifact, stream,
serve, `ffa_train`, bands, `cli.train --arch unet`) and phase 17's (the
zoo's 17 models, `zoo`, and the two `cli.test_long` runs of the
`.msgpack` fixture and its `.pth`, `test_long_msgpack`) and phase 17b's
(`zoo_harness` in this process; `zoo_eval`, `zoo_perturbation`,
`zoo_attack`, `zoo_fourier` and `zoo_predtime`, each subcommand's runs
together) and phase 17c's (`zoo_train` in this process, `zoo_train_cli`
the subprocess's three runs, `zoo_train_ddp` the two gloo ranks and the
NCCL rank), each counted from 0 over its own run. Every path runs
bf16 but the float32 frame, so K1's forward and backward go to the
tensor-core kernels there and the CUDA-core ones have 0 launches; the W-MSA paths run no K1. No
path runs K3 (no entry point of the JAX package runs its TPU kernels
either): its launches, on either kernel, are 0.
Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME = (1200, 1600)
SEED = 1234
# K1: f32 must match the twin to 1e-4 on every row. bf16: |Δ| <= 1.6e-2
# (2 bf16 ulps at magnitude 1-2) on all but 0.1% of rows — the selection is
# exact in both (float64 S), but the softmax sums run in another order, which
# can move a bf16 rounding of a1/a2 and of the output.
K1_TOL = {"float32": (1e-4, 0.0), "bfloat16": (1.6e-2, 1e-3)}
# K2: |Δ| <= atol + rtol·|ref|. f32 (TF32 off): sum order only, 1e-4.
# bf16: 1e-2 each (2.5 bf16 ulps): LN, Dense, GELU and dwconv round to bf16
# at the same points in both, but a sum-order difference can move one
# rounding by an ulp.
K2_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K2 with act_store (fp8, int8) against its twin: at most ACT_SHARE of the
# elements beyond K2_TOL, and every element within K2_TOL plus ACT_STEPS
# quantization steps at the output's largest magnitude (int8: its amax /
# 127; fp8: the e4m3 spacing there). Where the kernel and the twin round a
# value an ulp apart (sum order), a quantizer near a step boundary moves a
# whole step; at the LN output or in a hidden value that step reaches
# every output channel of the pixel and its neighbours, so an output far
# smaller than its pixel's largest can move by many of its own steps.
# Revised after the first chip run (PERF.md, PR 20): the first bar, one
# step of each element's own value, failed there for that reason.
ACT_SHARE = {"bfloat16": 0.005, "float32": 0.001}
ACT_STEPS = 2.0
# (dtype, mode, C) whose share beyond K2_TOL against the twin is held to
# the twin's own share against the same chain summed in float64
# (_k2_exact), measured on the same inputs in the same run, in place of
# ACT_SHARE: float32 int8 at C = 512 (serve dec0, hidden 2048). Nothing
# there rounds the hidden values to a coarser type before their round
# trip, so the last bit of a sum moves an int8 step wherever a value lies
# at a step's edge, and an output reads 9 x 2,048 of them: the twin itself
# lies 1.13-1.18% beyond K2_TOL from the float64 chain, the kernel that
# K2's float32 path replaced 0.32-0.34% from the twin (bit for bit
# today's outputs), so no float32 sum order but the twin's own meets 0.1%
# against it (scripts/k2_act_share.py; PERF.md). A control, the twin with
# its products in TF32, must lie beyond this bar, or the bar could not
# tell a loss of float32 precision. Its NaNs and ACT_STEPS are held as
# everywhere.
ACT_SHARE_BY_CHAIN = {("float32", "int8", 512)}
# K1 backward, per gradient tensor (dq, dk, dv, dbias): every element
# within tol·max|ref| of the twin, a bar set by the tensor's own scale (dq
# and dk are ~1e-3 where dv is ~1, so a bar of fixed size would pass a dq
# of zeros). f32 (TF32 off): sum order only, 1e-5. bf16: 2^-7, one bf16
# ulp at the tensor's largest magnitude — the selection is exact in both
# (float64 S), but the softmax sums run in another order, which can move
# the bf16 rounding of a1 (and of each output) by an ulp.
K1B_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# K1 and K3 in bf16 must also round where their own TPU kernel rounds. The
# variants ("v4" K1, "v1", "v23" K3-v2/v3; ops.probsparse) differ by about
# one bf16 ulp on a few percent of the elements, inside K1_TOL, so K1_TOL
# alone would pass one variant for another. So the kernel's mean gap to
# its own twin must be at most NUMERICS_SEP × its gap to the twin of each
# other numerics (mean |Δ| over the largest |own twin|, summed over the
# output tensors). In f32 the variants differ only by f32 roundings.
NUMERICS_SEP = 0.5
# 6a: CUDA (kernels) vs CPU (twins), f32 with TF32 off, same weights and
# sampling: summation order differs in every conv/Linear (cuDNN/cuBLAS vs
# oneDNN), ~1e-6 relative per layer, so max |Δ| on the [0, 1] image <= 1e-3.
MODEL_TOL = 1e-3
# 8: CUDA vs CPU, f32 with TF32 off, on noise images (see
# phase_train_parity). Each gradient leaf: ||Δ|| <=
# rtol·||ref|| + atol·sqrt(numel); atol 1e-9 covers the key biases, whose
# gradient is zero analytically (softmax ignores a per-row shift) and
# rounding noise (~1e-13) in fact.
# (a) the model's backward for one fixed output gradient: rtol 1e-4, the
#     sum order of cuBLAS/cuDNN against the CPU's (~1e-6 per layer).
# (b) a train step with Charbonnier + CR: the loss within 1e-5 relative;
#     leaves within rtol 5e-3, those fed only through the attention scores
#     (q/k projections, rel-pos tables) within 2e-2. The loss's own
#     gradient differs by ~1e-3 between the devices: the L1 terms of the CR
#     loss take sign(a - p) of VGG features that ReLU leaves at or near 0,
#     where a one-ulp difference flips the sign, and the Charbonnier
#     gradient d/sqrt(d² + eps²) has slope up to 1/eps = 1e3. The scores'
#     gradient is a softmax-gradient sum that cancels to ~1% of its terms,
#     which scales that difference up several times for those leaves.
STEP_TOL = {"model": 1e-4, "loss": 1e-5, "step": 5e-3, "step_scores": 2e-2,
            "atol": 1e-9}
# 11c: the remat train step's gradient leaves against the plain step's,
# from the same state, batch and generator states, with deterministic
# algorithms on: ||Δ|| <= REMAT_TOL·||ref|| per leaf. The recompute runs
# the same kernels on the same inputs (K1 deterministic, dbias summed in a
# fixed order), so the aim is 0; 1e-3 leaves room for one op whose CUDA
# implementation sums in a varying order.
REMAT_TOL = 1e-3
REMAT_REPS = 5  # timed steps of each
# 9: PSNR of the reloaded model_best.pth against the PSNR the run logged.
RELOAD_TOL = 1e-3
# The eval CLIs' per-image PSNR (printed to 4 decimals) against the
# in-process function with the same weights and seed, in dB.
EVAL_PSNR_TOL = 1e-3
STREAM_FRAMES = 4  # 1200×1600 frames of phase 9c's streams
TRAIN_BATCH, TRAIN_PS = 32, 128
# The nine stages of Uformer-32 (ModelConfig defaults) on the serving rect
# canvas 1280×1664: K2's x, with hidden width 4C; two K2 launches each per
# frame. The decoder stages see twice the encoder's C (the skip concat).
K2_STAGES = [("enc0", (1, 1280, 1664, 32)), ("enc1", (1, 640, 832, 64)),
             ("enc2", (1, 320, 416, 128)), ("enc3", (1, 160, 208, 256)),
             ("bottleneck", (1, 80, 104, 512)), ("dec0", (1, 160, 208, 512)),
             ("dec1", (1, 320, 416, 256)), ("dec2", (1, 640, 832, 128)),
             ("dec3", (1, 1280, 1664, 64))]
# H100 SXM peaks (NVIDIA data sheet), for the bounds: HBM bytes/s and
# dense FLOP/s by how the products run: bf16 on the tensor cores; float32
# on the CUDA cores (FFMA); float32 as three TF32 products each on the
# tensor cores (3xTF32, K2's float32 Dense layers); float64 on the CUDA
# cores (K1's float32 S, an ordered fma chain per element).
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3,
              "float64": 34e12}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    card = r.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return card


def bound(nbytes: float, flops, dname: str):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of the operands' type; flops is a count
    at dname's peak or {peak (a PEAK_FLOPS key): count}."""
    if not isinstance(flops, dict):
        flops = {dname: flops}
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = sum(f / PEAK_FLOPS[k] for k, f in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from dehaze_tpu_torch.data import images
    from dehaze_tpu_torch.ops.kernels import _build, leff, window_attention

    libs = (("window_attention", window_attention._SIGNATURES),
            ("window_attention_tc", window_attention._TC_SIGNATURES),
            ("leff", leff._SIGNATURES))
    t0 = time.perf_counter()
    hosts = (("png_unfilter", images._UNFILTER),
             ("jpeg_decode", images._JPEG))
    # one compiler per source, all started together
    with cf.ThreadPoolExecutor(len(libs) + len(hosts)) as ex:
        done = [ex.submit(_build.load_host_library, *a) for a in hosts]
        done += [ex.submit(_build.load_library, *a) for a in libs]
        for d in done:
            d.result()
    print(f"built {len(libs)} kernel libraries, the PNG unfilter and the "
          f"JPEG decoder in {time.perf_counter() - t0:.1f}s (parallel nvcc, "
          "cc)", flush=True)
    for name, _ in libs:
        secs, report = _build.build_info.get(name, (0.0, ""))
        usage = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {name}: {secs:.1f}s nvcc sm_90a from "
              f"dehaze_tpu_torch/csrc/{name}.cu; " + " | ".join(usage),
              flush=True)


def _textured_frame(seed: int, size=FRAME):
    """A synthetic hazy scene (1200×1600 by default) with sensor-like
    noise, uint8."""
    import numpy as np

    from dehaze_tpu_torch.data.synth import make_scene

    rng = np.random.default_rng(seed)
    _, hazy = make_scene(rng, size)
    noisy = hazy * 255.0 + rng.normal(0.0, 2.0, size=hazy.shape)
    return np.clip(noisy + 0.5, 0, 255).astype(np.uint8)


def _bmp24(img) -> bytes:
    """uint8 RGB [H, W, 3] as an uncompressed bottom-up 24-bit BMP."""
    import struct

    import numpy as np

    h, w, _ = img.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 54 + rows.size, 0, 0,
                       54, 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return head + rows.tobytes()


def phase_codec():
    """The port's image codec on the host at 1200×1600: the PNG encoder's
    per-row filters, its decoder (the compiled unfilter) and the BMP
    decoder, each against the pixels; the JPEG decoder (compiled) on the
    committed fixtures (among them the serving frame as 4:2:0, CMYK and
    arithmetic-coded JPEG, each timed), each against cv2's hash."""
    import hashlib
    import zlib

    import numpy as np

    from dehaze_tpu_torch.data import images

    from dehaze_tpu_torch.data.synth import make_scene

    def filters_of(png):
        raw = zlib.decompress(b"".join(b for k, b in images._chunks(png)
                                       if k == b"IDAT"))
        return np.bincount(np.frombuffer(raw, np.uint8).reshape(
            FRAME[0], -1)[:, 0], minlength=5)

    img = _textured_frame(SEED)
    t0 = time.perf_counter()
    png = images.encode_img(img)
    enc_ms = (time.perf_counter() - t0) * 1e3
    filters = filters_of(png)
    # a scene as the eval and training sets hold them (no noise)
    scene = filters_of(images.encode_img(make_scene(
        np.random.default_rng(SEED), FRAME)[1]))
    bmp = _bmp24(img)
    ms = {}
    for name, data in (("png", png), ("bmp", bmp)):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = images.decode_img(data, u8=True)
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(out, img):
            fail(f"codec: the {name} decode differs from the pixels")
        ms[name] = float(np.median(times))
    # the committed JPEG fixtures against the SHA-256 of cv2's decode
    # (scripts/make_jpeg_fixtures.py; this host has no cv2)
    fixtures = os.path.join(REPO, "tests", "data")
    with open(os.path.join(fixtures, "jpeg_fixtures.json")) as f:
        manifest = json.load(f)["files"]
    for name, want in manifest.items():
        with open(os.path.join(fixtures, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(5 if name.startswith("scene") else 1):
            t0 = time.perf_counter()
            out = images.decode_img(data, u8=True)
            times.append((time.perf_counter() - t0) * 1e3)
        digest = hashlib.sha256(out.tobytes()).hexdigest()
        if list(out.shape) != want["shape"] or digest != want["sha256"]:
            fail(f"codec: {name} decodes to {list(out.shape)} sha256 "
                 f"{digest[:16]}..., cv2 to {want['shape']} "
                 f"{want['sha256'][:16]}...")
        ms[name] = float(np.median(times))
    jpegs = ", ".join(
        f"{n} ({manifest[n]['bytes'] / 1e6:.2f} MB) {ms[n]:.1f} ms"
        for n in manifest if n.startswith("scene"))
    print(f"codec {FRAME[0]}x{FRAME[1]} (host): PNG encode {enc_ms:.1f} ms, "
          f"{len(png) / 1e6:.2f} MB, rows by filter None/Sub/Up/Average/"
          f"Paeth {filters.tolist()} (a noise-free synthetic scene: "
          f"{scene.tolist()}); decode PNG {ms['png']:.1f} ms, 24-bit BMP "
          f"{ms['bmp']:.1f} ms, JPEG (4:2:0 q95, CMYK q85, arithmetic SOF9 "
          f"q95) {jpegs} (median of 5); pixels equal; the {len(manifest)} "
          f"JPEG fixtures (progressive, EXIF orientation 6, block "
          f"smoothing, CMYK, YCCK, arithmetic sequential and progressive) "
          f"decode to cv2's SHA-256", flush=True)
    if int((filters > 0).sum()) < 2 or int((scene > 0).sum()) < 2:
        fail("codec: the PNG encoder wrote one filter type on every row")


def _attn_case(g, dev, heads, win, reg_hw):
    """(sample_idx, bias, region ids or None, nW) for one attention case."""
    import numpy as np
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops import window as win_ops

    N = win * win
    si = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, N, size=(N, ps_ops.probsparse_u(N))).astype(np.int32))
    bias = torch.randn(heads, N, N, generator=g, device=dev) * 0.1
    region = None
    if reg_hw is not None:
        region = torch.from_numpy(win_ops.shift_region_ids(
            reg_hw[0], reg_hw[1], win, win // 2)).to(dev)
    nW = region.shape[0] if region is not None else 1
    return si, bias, region, nW


def _pad_case(X, h, w, H, W, win):
    """Padding flags [nW, N] of an h×w frame centred on an X² canvas
    (infer.anyres), at a stage of H×W with windows win×win: the model's own
    resize (models.uformer.pad_flags)."""
    import torch

    from dehaze_tpu_torch.infer.anyres import expand2square
    from dehaze_tpu_torch.models.uformer import pad_flags

    _, pad, _ = expand2square(torch.zeros(1, h, w, 1, device="cuda"), X)
    return pad_flags(pad, H, W, win)


def _check_rows(label, got, want, D, dname, wrong):
    """K1_TOL per row of D values; returns (max|d|, text)."""
    import torch

    diff = (got.float() - want.float()).abs()
    row_err = diff.reshape(-1, D).amax(-1)
    tol, share = K1_TOL[dname]
    bad = int((row_err > tol).sum())
    if not torch.isfinite(got.float()).all():
        wrong.append(f"{label}: non-finite output")
    elif bad > share * row_err.numel():
        wrong.append(f"{label}: {bad} rows beyond {tol:g} (allowed "
                     f"{share:.1%})")
    err = float(diff.max())
    return err, f"max|d|={err:.3e} rows>{tol:g}: {bad}/{row_err.numel()}"


def _check_grads(label, got, want, dname, wrong):
    """K1B_TOL per gradient tensor; returns (max|d|, text)."""
    import torch

    tol = K1B_TOL[dname]
    stats, worst = [], 0.0
    for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if a is None and b is None:
            continue
        d = (a.float() - b.float()).abs()
        ref = float(b.float().abs().max())
        nb = int((d > tol * ref).sum())
        if not torch.isfinite(a.float()).all():
            wrong.append(f"{label}: non-finite {gname}")
        elif nb:
            wrong.append(f"{label}: {nb} {gname} elements beyond "
                         f"{tol:g}·max|ref|")
        worst = max(worst, float(d.max()))
        stats.append(f"{gname} {float(d.max()):.3e}/{ref:.3e}")
    return worst, "max|d|/max|ref| " + ", ".join(stats)


def _flipped_rows(got, q, k, v, kw, numerics="v4"):
    """Rows where a K1 (or K3, numerics "v23" or "v1") forward's choice
    between a2 @ V and mean(V) differs from the twin's selection. Both
    forward kernels write mean(V) as the float32 sum over tokens in token
    order, divided by N and rounded, so a row is a mean(V) row iff it
    equals that bit for bit. Token-major [B_, N, C] with kw["num_heads"],
    else head-major [B, H, N, D]."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps

    if "num_heads" in kw:
        heads = kw["num_heads"]
        got, q, k, v = (ps._heads(t, heads) for t in (got, q, k, v))
    B, H, N, D = q.shape
    row_mask = ps._chain_bhnd(
        q, k, v, kw["sample_idx"], kw.get("rel_pos_bias"),
        ps.attention_mask(kw.get("sw_region"), kw.get("pad_flag")), 5,
        ps._scale(q, 1, None), numerics)[3]
    s = torch.zeros(B, H, D, device=v.device)
    for j in range(N):
        s = s + v[:, :, j].float()
    # the kernels divide by N; torch's division by a number multiplies by
    # its reciprocal, which rounds otherwise where N is not a power of 2
    mean = (s / torch.full_like(s, N)).to(v.dtype)
    is_mean = (got == mean[:, :, None]).all(-1)
    return int((is_mean == row_mask).sum())


def _check_numerics(label, got, want, twin_of, own, wrong):
    """NUMERICS_SEP: the kernel's mean gap to its own twin (`want`, numerics
    `own`) against its gaps to the twins of the other numerics; returns the
    gaps as text."""
    import torch

    from dehaze_tpu_torch.ops.probsparse import NUMERICS

    def parts(t):
        return (t,) if torch.is_tensor(t) else [x for x in t if x is not None]

    gaps = {}
    for n in NUMERICS:
        ref = want if n == own else twin_of(n)
        gaps[n] = sum(float((a.float() - b.float()).abs().mean()
                            / o.float().abs().max())
                      for a, b, o in zip(parts(got), parts(ref), parts(want)))
    nearest = min((n for n in NUMERICS if n != own), key=gaps.get)
    if not gaps[own] <= NUMERICS_SEP * gaps[nearest]:
        wrong.append(f"{label}: mean gap to its own twin ({own}) "
                     f"{gaps[own]:.2e} is not below {NUMERICS_SEP:g} × its "
                     f"gap to the {nearest} twin {gaps[nearest]:.2e}")
    return "; mean gap by twin " + ", ".join(f"{n} {v:.2e}"
                                             for n, v in gaps.items())


def _run_case(label, kern, twin, check, nbytes, flops, dname, reps=10):
    """One kernel case: the kernel and its twin on the same inputs,
    check(got, want) -> (max|d|, text), the mean time of each (CUDA events)
    and the bound. Prints one line; returns (max|d|, ms, twin ms, bound ms,
    bound by)."""
    import torch

    got, want = kern(), twin()
    torch.cuda.synchronize()
    err, text = check(got, want)
    del got, want
    ms, plain_ms = cuda_ms(kern, reps), cuda_ms(twin, 3)
    b_ms, b_by = bound(nbytes, flops, dname)
    print(f"{label}: {text} kernel {ms:.3f} ms twin {plain_ms:.3f} ms bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return err, ms, plain_ms, b_ms, b_by


def _attn_run(label, kern, twin_of, own, q, kw, nW, bwd, wrong, kv=None):
    """An attention kernel (K1 or K3) against `twin_of(own)`: K1_TOL per
    row (forward) or K1B_TOL per gradient tensor (backward), and in bf16
    NUMERICS_SEP against the twins of the other numerics. kw holds
    num_heads for q/k/v [B_, N, C]; without it they are head-major [B, H,
    N, D]. Bytes: q/k/v and the output (q/k/v/g and dq/dk/dv in a
    backward), the bias (read, and written once more in a backward), the
    count matrix and each [nW, N] mask; operations: S (2·N²·D per window
    and head; in float32 at the float64 rate of the CUDA cores) and PV for
    the u kept rows (2·u·N·D; 8·u·N·D for dv, da2, dq and dk in a
    backward)."""
    from dehaze_tpu_torch.ops.probsparse import probsparse_u

    dname = str(q.dtype).split(".")[1]
    head_major = "num_heads" not in kw
    B, N = q.shape[0], q.shape[-2]
    heads = q.shape[1] if head_major else kw["num_heads"]
    D = q.shape[-1] if head_major else q.shape[-1] // heads
    bias = kw.get("rel_pos_bias")
    masks = sum(kw.get(m) is not None for m in ("sw_region", "pad_flag"))
    nbytes = ((7 if bwd else 4) * q.numel() * q.element_size()
              + (0 if bias is None else (2 if bwd else 1) * bias.numel() * 4)
              + N * N * 4 + (masks * nW * N * 4 if nW > 1 else 0))
    s_flops = B * heads * 2 * N * N * D
    other = B * heads * (8 if bwd else 2) * probsparse_u(N) * N * D
    # float32: S in float64 on the CUDA cores (an ordered fma chain per
    # element, as the kernels and the backward's recomputation need it)
    flops = ({"float64": s_flops, "float32": other} if dname == "float32"
             else s_flops + other)

    def check(got, want):
        if bwd:
            err, text = _check_grads(label, got, want, dname, wrong)
        else:
            err, text = _check_rows(label, got, want, D, dname, wrong)
        if kv is not None:  # (k, v) of a token-major call: the selection
            flips = (_bwd_flipped_rows(got, want, q, kv[0], kv[1], kw, own)
                     if bwd else _flipped_rows(got, q, kv[0], kv[1], kw, own))
            text += f" flipped rows {flips}"
            if flips:
                wrong.append(f"{label}: {flips} rows flipped between "
                             "a2 @ V and mean(V)")
        if dname == "bfloat16":
            text += _check_numerics(label, got, want, twin_of, own, wrong)
        return err, text

    return _run_case(label, kern, lambda: twin_of(own), check, nbytes,
                     flops, dname)


def _qkv(g, dev, shape, dtype, scales):
    """Seeded normal tensors on the card, one per scale."""
    import torch

    return [torch.randn(*shape, generator=g, device=dev).mul_(s).to(dtype)
            for s in scales]


def _k1_kernel(q, heads):
    """Which K1 forward kernel takes q: "tc", "f32" or "cuda_core"."""
    from dehaze_tpu_torch.ops.kernels.window_attention import fwd_kernel_for

    return fwd_kernel_for(q.dtype, "v4", q.shape[1], q.shape[2] // heads)


def phase_k1():
    """K1 forward at the serving frame's nine stages (shifted), N = 16, the
    training enc0 and 16×16 windows (N = 256, training enc0 at
    --win_size 16): f32 at all of them (K1's float32 kernel at N <= 64,
    the CUDA-core kernel at N = 256), bf16 at all, with q and k at std 0.5
    and, where the tensor-core kernel runs, also at std 2; each call
    counted on the kernel `fwd_kernel_for` names. Returns rows (case,
    dtype, kernel, max|d|, ms, twin ms, bound ms, bound by)."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        window_attention_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    H0, W0 = 1280, 1664
    # (name, windows B_, C, heads, win, region-map H x W or None)
    cases = [("enc0", 33280, 32, 1, 8, (H0, W0)),
             ("enc1", 8320, 64, 2, 8, (H0 // 2, W0 // 2)),
             ("enc2", 2080, 128, 4, 8, (H0 // 4, W0 // 4)),
             ("enc3", 520, 256, 8, 8, (H0 // 8, W0 // 8)),
             ("bottleneck", 130, 512, 16, 8, None),
             ("dec0", 520, 512, 16, 8, (H0 // 8, W0 // 8)),
             ("dec1", 2080, 256, 8, 8, (H0 // 4, W0 // 4)),
             ("dec2", 8320, 128, 4, 8, (H0 // 2, W0 // 2)),
             ("dec3", 33280, 64, 2, 8, (H0, W0)),
             ("N16", 2080, 128, 4, 4, None),
             ("train_enc0", 8192, 32, 1, 8, (TRAIN_PS, TRAIN_PS)),
             ("N256", 2048, 32, 1, 16, (TRAIN_PS, TRAIN_PS))]
    results, wrong = [], []
    counter = {"tc": "launches_tc", "f32": "launches_f32",
               "cuda_core": "launches"}
    for name, B, C, heads, win, reg_hw in cases:
        N = win * win
        si, bias, region, nW = _attn_case(g, dev, heads, win, reg_hw)
        runs = [(torch.float32, 0.5), (torch.bfloat16, 0.5),
                (torch.bfloat16, 2.0)]
        for dtype, std in runs:
            q, k, v = _qkv(g, dev, (B, N, C), dtype, (std, std, 0.5))
            kern = _k1_kernel(q, heads)
            if kern == "cuda_core" and std != 0.5:
                continue
            before = getattr(window_attention_fwd, counter[kern])
            kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                      sw_region=region)
            dname = str(dtype).split(".")[1]
            results.append((name if std == 0.5 else f"{name} std{std:g}",
                            dname, kern) + _attn_run(
                f"K1 {kern} {name} {dname} B_={B} C={C} h={heads} N={N} "
                f"shifted={region is not None} q,k std {std:g}",
                lambda: window_attention_fwd(q, k, v, num_windows=nW, **kw),
                lambda n: ps_ops.probsparse_attention_bnc(
                    q, k, v, numerics=n, **kw), "v4", q, kw, nW, False,
                wrong, kv=(k, v)))
            if getattr(window_attention_fwd, counter[kern]) == before:
                wrong.append(f"K1 {name} {dtype}: no launch counted in "
                             f".{counter[kern]}")
            del q, k, v
    if wrong:  # every case is printed before the first failure stops us
        fail("; ".join(wrong))
    return results


def _bwd_kernel(q, heads):
    """Which K1 backward kernel takes q: "tc" or "cuda_core"."""
    from dehaze_tpu_torch.ops.kernels.window_attention import bwd_kernel_for

    return bwd_kernel_for(q.dtype, "v4", q.shape[1], q.shape[2] // heads)


def _bwd_flipped_rows(got, want, q, k, v, kw, numerics="v4"):
    """Rows where a K1 (or K3-v3) backward's kept rows differ from the
    twin's selection, as dq shows them: a kernel's dq is exactly zero on the
    rows it did not keep. So a flip is a nonzero dq on a row the twin does not
    keep, or a zero dq on a kept row where the twin's dq is far from zero
    (above 1e-30; a kept row whose softmax saturates under the -100 masks
    has a dq that rounds to zero in the twin too)."""
    from dehaze_tpu_torch.ops import probsparse as ps

    heads = kw["num_heads"]
    row_mask = ps._chain_bhnd(
        ps._heads(q, heads), ps._heads(k, heads), ps._heads(v, heads),
        kw["sample_idx"], kw.get("rel_pos_bias"),
        ps.attention_mask(kw.get("sw_region"), kw.get("pad_flag")), 5,
        ps._scale(q, heads, None), numerics)[3]
    zero = (ps._heads(got[0], heads) == 0).all(-1)
    clear = ps._heads(want[0].float(), heads).abs().amax(-1) > 1e-30
    return int((~row_mask & ~zero).sum() + (row_mask & clear & zero).sum())


def _k1_f32_train_grads(g, dev, wrong):
    """A float32 train step's attention at the training enc0 and dec3
    shapes through `fused_window_attention` (autograd: K1's float32
    forward kernel, then the CUDA-core backward, which recomputes the
    selection): q, k, v and bias gradients within K1B_TOL of the twin's,
    and both passes keep the twin's rows (0 flipped rows in the forward's
    output, and in dq, which is zero exactly on the rows the backward did
    not keep), so they agree on every kept row."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        fused_window_attention, window_attention_fwd)

    P = TRAIN_PS
    for name, B, C, heads, reg_hw in (("enc0", 8192, 32, 1, (P, P)),
                                      ("dec3", 8192, 64, 2, (P, P))):
        si, bias, region, nW = _attn_case(g, dev, heads, 8, reg_hw)
        q, k, v, go = _qkv(g, dev, (B, 64, C), torch.float32,
                           (0.5, 0.5, 0.5, 1))
        kw = dict(num_heads=heads, sample_idx=si, sw_region=region)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        before = window_attention_fwd.launches_f32
        out = fused_window_attention(*leaves[:3], rel_pos_bias=leaves[3],
                                     num_windows=nW, **kw)
        out.backward(go)
        torch.cuda.synchronize()
        label = f"K1 f32 train step {name} B_={B} C={C} h={heads}"
        if window_attention_fwd.launches_f32 != before + 1:
            wrong.append(f"{label}: the forward did not run K1's float32 "
                         "kernel")
        got = [t.grad for t in leaves]
        kw["rel_pos_bias"] = bias
        want = ps_ops.probsparse_attention_bnc_bwd(q, k, v, go, **kw)
        _, text = _check_grads(label, got, want, "float32", wrong)
        flips = (_flipped_rows(out.detach(), q, k, v, kw),
                 _bwd_flipped_rows(got, want, q, k, v, kw))
        if any(flips):
            wrong.append(f"{label}: flipped rows (forward, backward) "
                         f"{flips}")
        print(f"{label} through autograd against the twin: {text}; flipped "
              f"rows (forward, backward) {flips}", flush=True)
        del q, k, v, go, leaves, out, got, want


def phase_k1_bwd():
    """K1 backward at the training path's shapes (batch 32 × 128²), f32
    (the CUDA-core kernel) and bf16 (the tensor-core kernel) with q and k
    at std 0.5 and 2, and at 16×16 windows (N = 256, the CUDA-core kernel,
    bf16). Returns rows (case, dtype, kernel, max|d|, ms, twin ms, bound
    ms, bound by)."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        window_attention_bwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    P = TRAIN_PS
    # the training path's shapes at batch 32 × 128² (N = 64, D = 32), and
    # enc0 at --win_size 16
    cases = [("enc0", 8192, 32, 1, 8, (P, P)),
             ("enc1", 2048, 64, 2, 8, (P // 2, P // 2)),
             ("bottleneck", 32, 512, 16, 8, None),
             ("dec3", 8192, 64, 2, 8, (P, P)),
             ("N256", 2048, 32, 1, 16, (P, P))]
    results, wrong = [], []
    before = (window_attention_bwd.launches, window_attention_bwd.launches_tc)
    _k1_f32_train_grads(g, dev, wrong)
    for name, B, C, heads, win, reg_hw in cases:
        N = win * win
        si, bias, region, nW = _attn_case(g, dev, heads, win, reg_hw)
        runs = [(torch.float32, 0.5)] if win == 8 else []
        runs += [(torch.bfloat16, 0.5), (torch.bfloat16, 2.0)]
        for dtype, std in runs:
            q, k, v, go = _qkv(g, dev, (B, N, C), dtype, (std, std, 0.5, 1))
            kern = _bwd_kernel(q, heads)
            if kern == "cuda_core" and std != 0.5:
                continue
            kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                      sw_region=region)
            dname = str(dtype).split(".")[1]
            results.append((name if std == 0.5 else f"{name} std{std:g}",
                            dname, kern) + _attn_run(
                f"K1 bwd {kern} {name} {dname} B_={B} C={C} h={heads} N={N} "
                f"shifted={region is not None} q,k std {std:g}",
                lambda: window_attention_bwd(q, k, v, go, num_windows=nW,
                                             **kw),
                lambda n: ps_ops.probsparse_attention_bnc_bwd(
                    q, k, v, go, numerics=n, **kw), "v4", q, kw, nW, True,
                wrong, kv=(k, v) if kern == "tc" else None))
            del q, k, v, go
    if wrong:  # every case is printed before the first failure stops us
        fail("; ".join(wrong))
    if (window_attention_bwd.launches == before[0]
            or window_attention_bwd.launches_tc == before[1]):
        fail("a K1 backward launch counter (CUDA cores, tensor cores) did "
             "not move")
    return results


def phase_k1_pad():
    """K1 with padding flags against its twin at the any-resolution shapes
    of one 1200×1600 frame on the 1664² canvas (enc0 shifted and padded,
    the bottleneck padded) and at enc0 of the 1000×1500 frame on 1536²,
    f32 and bf16; then the backward with padding at the training enc0
    shape (a 100×120 frame on each 128² crop). At enc0 the 1200×1600
    frame's border lies on window edges (every window all padding or all
    image, where the −100 cancels in the softmax); the 1000×1500 frame's
    does not."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        window_attention_bwd, window_attention_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    X = 1664
    # (name, B_, C, heads, region map or None, pad flags, backward): the
    # backward's crops each hold a 100×120 frame (flags and region ids
    # [256, 64], by window % 256)
    cases = [("enc0", 43264, 32, 1, (X, X), _pad_case(X, *FRAME, X, X, 8),
              False),
             ("enc0_1536", 36864, 32, 1, (1536, 1536),
              _pad_case(1536, 1000, 1500, 1536, 1536, 8), False),
             ("bottleneck", 169, 512, 16, None,
              _pad_case(X, *FRAME, X // 16, X // 16, 8), False),
             ("train_enc0", TRAIN_BATCH * 256, 32, 1, (TRAIN_PS, TRAIN_PS),
              _pad_case(TRAIN_PS, 100, 120, TRAIN_PS, TRAIN_PS, 8), True)]
    results, wrong = [], []
    runs = [(torch.float32, 0.5), (torch.bfloat16, 0.5),
            (torch.bfloat16, 2.0)]
    for name, B, C, heads, reg_hw, pad, bwd in cases:
        si, bias, region, _ = _attn_case(g, dev, heads, 8, reg_hw)
        nW = pad.shape[0]
        for dtype, std in runs:
            q, k, v, go = _qkv(g, dev, (B, 64, C), dtype, (std, std, 0.5, 1))
            kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                      sw_region=region, pad_flag=pad)
            dname = str(dtype).split(".")[1]
            if bwd:
                def kern():
                    return window_attention_bwd(q, k, v, go, num_windows=nW,
                                                **kw)

                def twin_of(n):
                    return ps_ops.probsparse_attention_bnc_bwd(
                        q, k, v, go, numerics=n, **kw)
            else:
                def kern():
                    return window_attention_fwd(q, k, v, num_windows=nW,
                                                **kw)

                def twin_of(n):
                    return ps_ops.probsparse_attention_bnc(q, k, v,
                                                           numerics=n, **kw)
            kname = (f"{_bwd_kernel(q, heads)}_bwd" if bwd
                     else _k1_kernel(q, heads))
            case = (f"bwd pad {name}" if bwd else f"pad {name}") + (
                "" if std == 0.5 else f" std{std:g}")
            results.append((case, dname, kname) + _attn_run(
                f"K1 {kname} pad {name} {dname} B_={B} C={C} "
                f"h={heads} shifted={region is not None} padded tokens "
                f"{int(pad.sum())}/{pad.numel()} q,k std {std:g}", kern,
                twin_of, "v4", q, kw, nW, bwd, wrong,
                kv=None if kname == "cuda_core_bwd" else (k, v)))
    if wrong:
        fail("; ".join(wrong))
    return results


def phase_k3():
    """The K3 kernels (older TPU variants, other rounding points) against
    their twins: v1 and v2 head-major [B, H, N, D] at the serving shapes
    (enc1 shifted, bottleneck), f32 on the CUDA-core kernel and bf16 on
    the tensor-core one with q and k at std 1, 0.5 and 2; the v3 forward and
    backward at the training enc0 and enc1 shapes, f32 (the CUDA-core
    kernels) and bf16 (the tensor-core ones) with q and k at std 1 (where
    the rounding of S moves the output, NUMERICS_SEP), and in bf16 also at
    std 0.5 and 2 and with padding flags (a 100×120 frame on each 128²
    crop); 0 flipped rows in bf16. Each call must reach the kernel that
    `fwd_kernel_for` / `bwd_kernel_for` names, by its launch counter.
    Returns {kernel: rows (case, dtype, kernel, max|d|, ms, twin ms, bound
    ms, bound by)}."""
    import torch

    from dehaze_tpu_torch.ops import probsparse as ps_ops
    from dehaze_tpu_torch.ops.kernels.window_attention import (
        bwd_kernel_for, fwd_kernel_for, probsparse_window_attention_v1,
        probsparse_window_attention_v2, window_attention_v3_bwd,
        window_attention_v3_fwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    N, D = 64, 32
    P = TRAIN_PS
    results, wrong = {}, []

    def counted(entry, attr, fn):
        """fn() once more, which must add one to entry.attr, then fn."""
        before = getattr(entry, attr)
        fn()
        if getattr(entry, attr) != before + 1:
            wrong.append(f"{entry.__name__}: the call did not reach the "
                         f"kernel counted in .{attr}")
        return fn

    for vname, entry, own in (("v1", probsparse_window_attention_v1, "v1"),
                              ("v2", probsparse_window_attention_v2, "v23")):
        for name, B, heads, reg_hw in (("enc1", 8320, 2, (640, 832)),
                                       ("bottleneck", 130, 16, None)):
            si, bias, region, nW = _attn_case(g, dev, heads, 8, reg_hw)
            for dtype, std in ((torch.float32, 1.0), (torch.bfloat16, 1.0),
                               (torch.bfloat16, 0.5), (torch.bfloat16, 2.0)):
                q, k, v = _qkv(g, dev, (B, heads, N, D), dtype,
                               (std, std, 0.5))
                kw = dict(sample_idx=si, rel_pos_bias=bias, sw_region=region)
                dname = str(dtype).split(".")[1]
                kf = fwd_kernel_for(dtype, own, N, D, head_major=True)
                if (dtype == torch.bfloat16) != (kf == "tc"):
                    wrong.append(f"K3-{vname} {name} {dname}: routed to "
                                 f"{kf}")
                case = name if std == 1.0 else f"{name} std{std:g}"
                results.setdefault(vname, []).append(
                    (case, dname, kf) + _attn_run(
                        f"K3-{vname} {kf} {name} {dname} [B,H,N,D]="
                        f"[{B},{heads},{N},{D}] shifted={region is not None}"
                        f" q,k std {std:g}",
                        counted(entry,
                                "launches_tc" if kf == "tc" else "launches",
                                lambda: entry(q, k, v, num_windows=nW, **kw)),
                        lambda n: ps_ops.probsparse_attention_bhnd(
                            q, k, v, numerics=n, **kw), own, q, kw, nW, False,
                        wrong, kv=(k, v) if kf == "tc" else None))
                del q, k, v
    # (name, B_, C, heads, region map, pad flags or None, dtype, q/k std)
    pad = _pad_case(P, 100, 120, P, P, 8)
    cases = []
    for name, B, C, heads in (("train_enc0", 8192, 32, 1),
                              ("train_enc1", 2048, 64, 2)):
        hw = (P, P) if name == "train_enc0" else (P // 2, P // 2)
        cases += [(name, B, C, heads, hw, None, torch.float32, 1.0)]
        cases += [(name, B, C, heads, hw, None, torch.bfloat16, std)
                  for std in (1.0, 0.5, 2.0)]
    cases += [("pad train_enc0", 8192, 32, 1, (P, P), pad, torch.bfloat16,
               1.0)]
    for name, B, C, heads, reg_hw, pflag, dtype, std in cases:
        si, bias, region, nW = _attn_case(g, dev, heads, 8, reg_hw)
        if pflag is not None:
            nW = pflag.shape[0]
        q, k, v, go = _qkv(g, dev, (B, N, C), dtype, (std, std, 0.5, 1))
        kw = dict(num_heads=heads, sample_idx=si, rel_pos_bias=bias,
                  sw_region=region, pad_flag=pflag)
        dname = str(dtype).split(".")[1]
        case = name if std == 1.0 else f"{name} std{std:g}"
        label = (f"{name} {dname} B_={B} C={C} h={heads} "
                 f"shifted={region is not None} padded="
                 f"{pflag is not None} q,k std {std:g}")
        kf = fwd_kernel_for(dtype, "v23", N, C // heads)
        kb = bwd_kernel_for(dtype, "v23", N, C // heads)
        if (dtype == torch.bfloat16) != (kf == "tc" == kb):
            wrong.append(f"K3-v3 {label}: routed to {kf} / {kb}")
        results.setdefault("v3_fwd", []).append((case, dname, kf) + _attn_run(
            f"K3-v3 fwd {kf} {label}",
            counted(window_attention_v3_fwd,
                    "launches_tc" if kf == "tc" else "launches",
                    lambda: window_attention_v3_fwd(q, k, v, num_windows=nW,
                                                    **kw)),
            lambda n: ps_ops.probsparse_attention_bnc(
                q, k, v, numerics=n, **kw), "v23", q, kw, nW, False,
            wrong, kv=(k, v) if kf == "tc" else None))
        results.setdefault("v3_bwd", []).append((case, dname, kb) + _attn_run(
            f"K3-v3 bwd {kb} {label}",
            counted(window_attention_v3_bwd,
                    "launches_tc" if kb == "tc" else "launches",
                    lambda: window_attention_v3_bwd(q, k, v, go,
                                                    num_windows=nW, **kw)),
            lambda n: ps_ops.probsparse_attention_bnc_bwd(
                q, k, v, go, numerics=n, **kw), "v23", q, kw, nW, True,
            wrong, kv=(k, v) if kb == "tc" else None))
        del q, k, v, go
    if wrong:
        fail("; ".join(wrong))
    return results


def _k2_case(g, shape, Ch):
    """Seeded K2 parameters (float32, on g's device) for x of `shape` and
    hidden width Ch, then x itself."""
    import torch

    C = shape[-1]

    def rnd(*s, std=1.0, mean=0.0):
        return torch.randn(*s, generator=g, device=g.device) * std + mean

    p = {"ln_scale": rnd(C, std=0.1, mean=1.0),
         "ln_bias": rnd(C, std=0.1),
         "w1": rnd(C, Ch, std=1 / math.sqrt(C)), "b1": rnd(Ch, std=0.1),
         "dw_kernel": rnd(3, 3, 1, Ch, std=1 / 3),
         "dw_bias": rnd(Ch, std=0.1),
         "w2": rnd(Ch, C, std=1 / math.sqrt(Ch)), "b2": rnd(C, std=0.1)}
    return p, rnd(*shape)


def _k2_bytes_flops(x, p):
    """K2's bytes (x read, out written, the parameters read once) and
    operations (both Dense layers, the dwconv and its bias) for x; in
    float32 the Dense layers' at the 3xTF32 rate, the dwconv's at the CUDA
    cores' (`bound`)."""
    C, Ch = p["w1"].shape
    nbytes = (2 * x.numel() + sum(t.numel() for t in p.values())
              ) * x.element_size()
    pixels = x.numel() // C
    if x.element_size() == 4:  # float32
        return nbytes, {"3xtf32": pixels * 4 * C * Ch,
                        "float32": pixels * 18 * Ch}
    return nbytes, pixels * (4 * C * Ch + 18 * Ch)


def phase_k2():
    import torch

    from dehaze_tpu_torch.ops.kernels.leff import (kernel_smem_bytes,
                                                   leff_fused, leff_reference,
                                                   plan_tile)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    P, X = TRAIN_PS, 1664
    # serving's enc0 and bottleneck (rect canvas 1280×1664), evaluation's
    # on the 1664² square canvas and any-resolution's enc0 on 1536², and the
    # training eval forward's (batch 32, where the bottleneck's depthwise
    # conv sees 8×8 images): f32 and bf16, erf and tanh GELU
    cases = [("enc0", (1, 1280, 1664, 32), 128),
             ("bottleneck", (1, 80, 104, 512), 2048),
             ("eval_enc0", (1, X, X, 32), 128),
             ("eval_bottleneck", (1, X // 16, X // 16, 512), 2048),
             ("anyres_enc0_1536", (1, 1536, 1536, 32), 128),
             ("train_enc0", (TRAIN_BATCH, P, P, 32), 128),
             ("train_bottleneck", (TRAIN_BATCH, P // 16, P // 16, 512), 2048),
             # --train_ps 64: the 1216×1664 canvas, a 76-row bottleneck
             # (a ragged last row tile)
             ("bottleneck_1216", (1, 76, 104, 512), 2048)]
    sweep = [(d, f) for d in (torch.float32, torch.bfloat16)
             for f in (False, True)]
    # the other seven stages of the serving frame (K2_STAGES), exact GELU
    # only: bf16 (serving) and f32 (the float32 frame)
    cases = [c + (sweep,) for c in cases] + [
        (name, shape, 4 * shape[-1],
         [(torch.bfloat16, False), (torch.float32, False)])
        for name, shape in K2_STAGES if name not in ("enc0", "bottleneck")]
    for dtype in (torch.float32, torch.bfloat16):
        for C in sorted({c[1][-1] for c in cases}):
            for mode in (None, "fp8", "int8"):
                got = kernel_smem_bytes(C, dtype, mode)
                want = plan_tile(C, dtype, mode).smem
                if got != want:
                    fail(f"K2 C={C} {dtype} act_store={mode}: the kernel "
                         f"allocates {got} bytes of shared memory, the "
                         f"planner counts {want}")
    results, wrong = [], []
    for name, shape, Ch, runs in cases:
        p, x32 = _k2_case(g, shape, Ch)
        for dtype, fast in runs:
            x = x32.to(dtype)
            dname = str(dtype).split(".")[1]
            tol = K2_TOL[dname]
            gelu = "tanh" if fast else "erf"
            label = (f"K2 {name} {dname} gelu={gelu} x={list(shape)} "
                     f"hidden={Ch}")

            def check(got, want):
                diff = (got.float() - want.float()).abs()
                bad = int((diff > tol + tol * want.float().abs()).sum())
                if not torch.isfinite(got.float()).all() or bad:
                    wrong.append(f"{label}: {bad} elements beyond "
                                 f"atol=rtol={tol:g}")
                err = float(diff.max())
                return err, (f"max|d|={err:.3e} elements beyond tol: "
                             f"{bad}")

            results.append((name, dname, gelu) + _run_case(
                label, lambda: leff_fused(x, fast_gelu=fast, **p),
                lambda: leff_reference(x, fast_gelu=fast, **p), check,
                *_k2_bytes_flops(x, p), dname, reps=20))
    if wrong:
        fail("; ".join(wrong))
    return results


def _act_step(want, mode):
    """The quantization step of each stored output value: int8, the
    pixel's scale (its amax / 127); fp8, the e4m3 spacing at the value
    (2^(e - 3), 2^-9 below the smallest normal 2^-6)."""
    import torch

    w = want.float().abs()
    if mode == "int8":
        return (w.amax(dim=-1, keepdim=True) / 127).expand_as(w)
    return torch.exp2(torch.floor(torch.log2(w.clamp_min(2.0 ** -6))) - 3)


def _act_check(label, mode, dname, got, want, wrong, bar=None):
    """K2 with act_store against its twin: the same NaNs, then the bars
    ACT_SHARE (or `bar` where given: ACT_SHARE_BY_CHAIN) and ACT_STEPS.
    Returns (max|d|, share beyond K2_TOL, its largest excess in steps of
    the element's own value, and in steps at the output's largest
    magnitude, text)."""
    import torch

    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    if not torch.equal(torch.isnan(g), nan):
        wrong.append(f"{label}: NaN at {int(torch.isnan(g).sum())} elements,"
                     f" the twin at {int(nan.sum())}")
        return float("nan"), 1.0, float("inf"), float("inf"), "NaNs differ"
    tol = K2_TOL[dname]
    share_bar = ACT_SHARE[dname] if bar is None else bar
    d = torch.where(nan, 0.0, (g - w).abs())
    excess = torch.where(~nan, d - tol - tol * w.abs(), 0.0).clamp_min(0.0)
    share = float((excess > 0).sum()) / max(1, int((~nan).sum()))
    own = float(torch.where(nan, 0.0, excess / _act_step(w, mode)).max())
    top_w = torch.where(nan, 0.0, w.abs()).max().reshape(1, 1)
    top = float((excess / _act_step(top_w, mode)).max())
    err = float(d.max())
    if top > ACT_STEPS or share > share_bar or torch.isinf(g).any():
        wrong.append(f"{label}: {share:.4%} beyond K2_TOL (at most "
                     f"{share_bar:.4%}), {top:.3f} top steps beyond "
                     f"it (at most {ACT_STEPS:g})")
    return err, share, own, top, (
        f"max|d|={err:.3e}, {share:.4%} beyond K2_TOL (at most "
        f"{share_bar:.4%}), at most {own:.3f} own steps, {top:.3f} top "
        f"steps beyond it, NaN {int(nan.sum())}")


def _k2_exact(x, p, mode):
    """K2's twin (`leff_reference`, float32) with its LayerNorm, both Dense
    layers and the dwconv summed in float64, each rounded once to float32
    where the twin rounds; GELU and the act_store round trips as the twin
    has them."""
    import torch.nn.functional as F

    from dehaze_tpu_torch.ops.actstore import compress

    C, Ch = p["w1"].shape
    d = {k: v.double() for k, v in p.items()}

    def gelu(t):
        return F.gelu(t.float())

    xn = compress(F.layer_norm(x.double(), (C,), d["ln_scale"], d["ln_bias"],
                               1e-5).float(), mode)
    h = compress(gelu(F.linear(xn.double(), d["w1"].t(), d["b1"]).float()),
                 mode)
    dw = d["dw_kernel"].reshape(3, 3, Ch).permute(2, 0, 1)[:, None]
    h = F.conv2d(h.double().permute(0, 3, 1, 2), dw, d["dw_bias"], padding=1,
                 groups=Ch).permute(0, 2, 3, 1).float()
    h = compress(gelu(h), mode)
    return compress(F.linear(h.double(), d["w2"].t(), d["b2"]).float(), mode)


def _chain_bar(label, x, p, mode, twin, wrong):
    """The share bar of an ACT_SHARE_BY_CHAIN case: the float32 twin's own
    share beyond K2_TOL against _k2_exact. The control, the twin with its
    products in TF32, must lie beyond it against the twin. Returns (bar,
    text)."""
    import torch

    from dehaze_tpu_torch.ops.kernels.leff import leff_reference

    bar = _act_check(label, mode, "float32", twin, _k2_exact(x, p, mode),
                     [], 1.0)[1]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = leff_reference(x, act_store=mode, **p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    control = _act_check(label, mode, "float32", ctl, twin, [], 1.0)[1]
    if not control > bar:
        wrong.append(f"{label}: the TF32 control lies {control:.4%} beyond "
                     f"K2_TOL from the twin, within the bar {bar:.4%}")
    return bar, (f"bar: the twin {bar:.4%} beyond K2_TOL from its float64 "
                 f"chain; TF32 control {control:.4%} from the twin")


def _k2_actstore_cases():
    """phase_k2_actstore's (a) and (b): K2 with act_store against its twin;
    rows (case, dtype, mode, share beyond K2_TOL, own and top steps beyond
    it (_act_check), max|d|, ms, twin ms, bound ms, bound by)."""
    import torch

    from dehaze_tpu_torch.ops.kernels.leff import (leff_fused, leff_reference,
                                                   plan_tile)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    wrong, results = [], []
    # (a): int8 in one pass (enc0, dec3), two sweeps (enc2, enc3) and three
    # sweeps (bottleneck)
    cases = [(name, shape, torch.bfloat16) for name, shape in K2_STAGES
             if name in ("enc0", "dec3", "enc2", "enc3", "bottleneck")]
    cases += [(name, shape, torch.float32) for name, shape in K2_STAGES
              if name in ("enc0", "dec0")]
    for name, shape, dtype in cases:
        p, x32 = _k2_case(g, shape, 4 * shape[-1])
        x = x32.to(dtype)
        dname = str(dtype).split(".")[1]
        for mode in ("fp8", "int8"):
            plan = plan_tile(shape[-1], dtype, mode)
            label = (f"K2 act_store={mode} {name} {dname} x={list(shape)} "
                     f"hidden={4 * shape[-1]} tile 8x{plan.tw}, dense1 "
                     f"sweeps {plan.sweeps}")
            seen = {}
            by_chain = (dname, mode, shape[-1]) in ACT_SHARE_BY_CHAIN

            def check(got, want):
                bar, note = (_chain_bar(label, x, p, mode, want, wrong)
                             if by_chain else (None, ""))
                *seen["stats"], text = _act_check(label, mode, dname, got,
                                                  want, wrong, bar)
                return seen["stats"][0], f"{text}{'; ' if note else ''}{note}"

            row = _run_case(
                label, lambda: leff_fused(x, act_store=mode, **p),
                lambda: leff_reference(x, act_store=mode, **p), check,
                *_k2_bytes_flops(x, p), dname, reps=10)
            results.append((name, dname, mode) + tuple(seen["stats"][1:])
                           + row)
        del p, x32, x
    # (b)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        p, x32 = _k2_case(g, (1, 64, 96, 32), 128)
        for what, bias, scale, sparse in (("448", 448.0, 0.0, False),
                                          ("464", 464.0, 0.0, False),
                                          ("466", 466.0, 0.0, False),
                                          ("500 sparse", 500.0, 10.0, True)):
            q = dict(p, ln_bias=p["ln_bias"].clone(),
                     ln_scale=p["ln_scale"].clone(), w1=p["w1"].clone())
            # channel 0 feeds no hidden channel: its LN output is only
            # stored, so a NaN there is the fp8 cast's alone
            q["ln_bias"][0], q["ln_scale"][0], q["w1"][0] = bias, scale, 0.0
            x = x32.clone()
            if sparse:
                keep = torch.rand(x.shape[:-1], generator=g, device=dev) < 0.01
                x[..., 0] = torch.where(keep, x[..., 0], -20.0)
            x = x.to(dtype)
            got = leff_fused(x, act_store="fp8", **q)
            want = leff_reference(x, act_store="fp8", **q)
            label = f"K2 fp8 NaN case ln_bias {what} {dname}"
            text = _act_check(label, "fp8", dname, got, want, wrong)[-1]
            n_nan, n = int(torch.isnan(want).sum()), want.numel()
            ok = {"448": n_nan == 0, "464": n_nan == 0, "466": n_nan == n,
                  "500 sparse": 0 < n_nan < n // 2}[what]
            if not ok:
                wrong.append(f"{label}: the twin has {n_nan} of {n} NaN")
            print(f"{label}: {text} of {n}", flush=True)
    if wrong:
        fail("; ".join(wrong))
    return results


def phase_k2_actstore(tmp: str, pth: str):
    """--act_store on K2 and on the serving path (the modes' rows of the
    kernels line, and their paths' launch counts):
    (a) K2 with act_store fp8 and int8 against its twin (bf16 at the
        serving frame's enc0, dec3, enc2, enc3 and bottleneck shapes, exact
        GELU: int8 in one pass, two sweeps and three sweeps; f32, the
        3xTF32 classes with int8 in three sweeps, at enc0 and dec0):
        _act_check, kernel and twin ms;
    (b) fp8 NaN cases, [1, 64, 96, 32] in both types: LN output channels
        fixed at 448 and 464 (read back as 448: no NaN), 466 (NaN
        everywhere), and an ln_bias of 500 at ln_scale 10 where x is -20
        but at 1% of the pixels (NaN around those pixels only): the
        kernel's NaNs are the twin's;
    (c) the 1200×1600 frame (rect canvas, bf16) with act_store None, fp8
        and int8: s/frame, 18 K1 and 18 K2 launches and no twin call per
        frame, each mode's PSNR against the plain frame;
    (d) `cli.test_long --rect_canvas --act_store int8` in a subprocess on
        the three 1200×1600 pairs: per-image PSNR against the in-process
        forward, launches per frame."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.ops import metrics as M

    results = _k2_actstore_cases()
    dev = torch.device("cuda")
    # (c)
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)

    def whole_image(mode):
        model = build_model_and_params(ModelConfig(act_store=mode), pth, dev)
        return make_whole_image_fn(
            lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
            FRAME[0], FRAME[1], ps=128, square=False, device="cuda")

    paths, outs, reps = {}, {}, 3
    for mode in (None, "fp8", "int8"):
        run = whole_image(mode)
        run(frame)
        torch.cuda.synchronize()
        reset_counts()
        with _TwinCounts() as twins:
            t0 = time.perf_counter()
            for _ in range(reps):
                outs[mode] = run(frame)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / reps
        counts = {**read_counts(), **twins}
        y = outs[mode]
        psnr = float(M.psnr(y, outs[None]))
        print(f"frame {FRAME[0]}x{FRAME[1]} rect canvas bf16 act_store="
              f"{mode}: {secs:.4f} s/frame, launches over {reps} frames "
              f"K1 (tensor cores) {counts['k1_fwd_tc']} K2 {counts['k2']} "
              f"twins {twins}, PSNR against the plain frame {psnr:.3f} dB, "
              f"range [{float(y.min()):.4f}, {float(y.max()):.4f}]",
              flush=True)
        _check_launches(f"frame act_store={mode}", counts, reps)
        if not torch.isfinite(y).all() or tuple(y.shape) != (1,) + FRAME + (
                3,):
            fail(f"frame act_store={mode}: non-finite or misshapen output")
        if mode is not None:
            paths[mode] = {f"frame_{mode}": counts}
    # (d)
    long_dir = os.path.join(tmp, "eval_long")
    (out, stats), = _counted_clis([("test_long", [
        "--input_dir", long_dir, "--weights", pth, "--seed", SEED,
        "--rect_canvas", "--act_store", "int8", "--no-save_images"],
        "--rect_canvas --act_store int8")])[0]
    if stats["rc"] != 0:
        fail(f"cli.test_long --act_store int8 exited {stats['rc']}")
    lines = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out, re.M)
    run, worst = whole_image("int8"), 0.0
    for (name, psnr, _), (clean, hazy, fname) in zip(
            lines, val_images(PairedFolder(long_dir))):
        y = run(torch.from_numpy(hazy[None]).cuda())[0]
        ref = float(M.psnr(y, torch.from_numpy(clean).cuda()))
        worst = max(worst, abs(ref - float(psnr)))
    print(f"cli.test_long --rect_canvas --act_store int8: {len(lines)} "
          f"frames, launches per frame K2 {stats['k2'] / max(1, len(lines)):g}"
          f", per-image PSNR vs the in-process forward: max |d| "
          f"{worst:.2e} dB", flush=True)
    if len(lines) != 3 or worst > EVAL_PSNR_TOL:
        fail("cli.test_long --act_store int8: per-image PSNRs differ from "
             "the in-process forward's")
    _check_launches("cli.test_long --act_store int8", stats, len(lines))
    paths["int8"]["test_long_int8"] = stats
    return results, paths


FP8_CHUNK = 2 ** 26  # float32 patterns per call of phase_k2_trips
I8_CHUNK = 2 ** 10   # amaxes per call of phase_k2_trips (x 2^16 values)


def phase_k2_trips():
    """K2's round-trip device functions against `actstore.compress` on the
    card, NaN for NaN and bit for bit elsewhere:
    (a) fp8 (`leff.fp8_trip`: the hardware e4m3 convert and its NaN
        select, the code of K2's four fp8 sites): every bf16 pattern, and
        every float32 pattern in chunks of FP8_CHUNK;
    (b) int8 as K2's bf16 kernels quantize (`leff.i8_trip`: the division
        as a product and a remainder step): every bf16 value v against
        every amax a it can have in its row (every non-negative bf16
        pattern, inf and NaN with it; |v| <= a where a is finite), at
        compress's scale for a, against `i8_trip_reference` (compress's
        int8 steps in torch on the card) bit for bit, and against
        `compress([a, v], "int8")` as a value (its int8 cast gives +0
        where v / scale rounds to -0; the kernel keeps -0)."""
    import torch

    from dehaze_tpu_torch.ops import actstore
    from dehaze_tpu_torch.ops.kernels.leff import (fp8_trip, i8_trip,
                                                   i8_trip_reference)

    dev = torch.device("cuda")

    def differ(got, want, bits, keep=None):
        same = (got.view(bits) == want.view(bits)) | (got.isnan()
                                                      & want.isnan())
        if keep is not None:
            same |= ~keep
        return int((~same).sum())

    def fp8(x, bits):
        want = actstore.compress(x, "fp8")
        return differ(fp8_trip(x), want, bits), int(want.isnan().sum())

    t0 = time.perf_counter()
    pat = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=dev)
    v = pat.to(torch.int16).view(torch.bfloat16)
    bf_diff, bf_nan = fp8(v, torch.int16)
    f_diff = f_nan = 0
    for lo in range(-2 ** 31, 2 ** 31, FP8_CHUNK):
        x = torch.arange(lo, lo + FP8_CHUNK, dtype=torch.int32, device=dev)
        d, n = fp8(x.view(torch.float32), torch.int32)
        f_diff, f_nan = f_diff + d, f_nan + n
    t1 = time.perf_counter()
    print(f"K2 fp8 device function against compress(., 'fp8'): bf16 "
          f"{bf_diff} of 65536 patterns differ ({bf_nan} NaN); float32 "
          f"{f_diff} of {2 ** 32} differ ({f_nan} NaN); {t1 - t0:.1f} s",
          flush=True)
    i8_diff = i8_value = i8_zero = i8_pairs = 0
    amaxes = pat[pat >= 0].to(torch.int16).view(torch.bfloat16)
    for lo in range(0, amaxes.numel(), I8_CHUNK):
        a = amaxes[lo:lo + I8_CHUNK].repeat_interleave(v.numel())
        x = v.repeat(I8_CHUNK)
        keep = (x.abs() <= a) | ~a.isfinite()
        scale = torch.clamp_min(a, 1e-8) / torch.full_like(a, 127.0)
        got = i8_trip(x, scale)
        i8_diff += differ(got, i8_trip_reference(x, scale), torch.int16,
                          keep)
        ref = actstore.compress(torch.stack([a, x], -1), "int8")[:, 1]
        i8_value += int((keep & ((got != ref) & ~(got.isnan()
                                                  & ref.isnan()))).sum())
        i8_zero += differ(got, ref, torch.int16, keep)
        i8_pairs += int(keep.sum())
    print(f"K2 int8 device function: {i8_diff} of {i8_pairs} (value, amax) "
          f"pairs differ from i8_trip_reference; against compress(., "
          f"'int8') {i8_value} differ in value, {i8_zero} in bits (-0 for "
          f"+0); {time.perf_counter() - t1:.1f} s", flush=True)
    if bf_diff or f_diff:
        fail("K2's fp8 device function differs from compress(., 'fp8')")
    if i8_diff or i8_value:
        fail("K2's int8 device function differs from its reference")


def _counters():
    """{key: (entry point, counter attribute)} of every kernel."""
    from dehaze_tpu_torch.ops.kernels import window_attention as wa
    from dehaze_tpu_torch.ops.kernels.leff import leff_fused

    return {"k1_fwd_tc": (wa.window_attention_fwd, "launches_tc"),
            "k1_fwd": (wa.window_attention_fwd, "launches"),
            "k1_fwd_f32": (wa.window_attention_fwd, "launches_f32"),
            "k1_bwd_tc": (wa.window_attention_bwd, "launches_tc"),
            "k1_bwd": (wa.window_attention_bwd, "launches"),
            "k2": (leff_fused, "launches"),
            "k3_v1_tc": (wa.probsparse_window_attention_v1, "launches_tc"),
            "k3_v1": (wa.probsparse_window_attention_v1, "launches"),
            "k3_v2_tc": (wa.probsparse_window_attention_v2, "launches_tc"),
            "k3_v2": (wa.probsparse_window_attention_v2, "launches"),
            "k3_v3_fwd_tc": (wa.window_attention_v3_fwd, "launches_tc"),
            "k3_v3_fwd": (wa.window_attention_v3_fwd, "launches"),
            "k3_v3_bwd_tc": (wa.window_attention_v3_bwd, "launches_tc"),
            "k3_v3_bwd": (wa.window_attention_v3_bwd, "launches")}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def phase_model(tmp: str) -> str:
    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.models.uformer import Uformer

    torch.manual_seed(SEED)
    pth = os.path.join(tmp, "uformer32_seed.pth")
    torch.save({"state_dict": Uformer(ModelConfig()).state_dict()}, pth)
    print(f"saved seeded random-init Uformer-32 to {pth}", flush=True)

    # (a) CUDA kernels vs CPU twins, f32 (TF32 off), same sampling seed
    cfg32 = ModelConfig(dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        size=(1, 256, 256, 3)).astype(np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model_and_params(cfg32, pth, torch.device(dev))
        with torch.inference_mode():
            outs[dev] = model(x.to(dev), generator=torch.Generator()
                              .manual_seed(SEED)).cpu()
    d = (outs["cuda"] - outs["cpu"]).abs()
    print(f"model 256² f32 CUDA vs CPU: max|d|={float(d.max()):.3e} "
          f"mean|d|={float(d.mean()):.3e} pixels>1e-4: "
          f"{int((d > 1e-4).sum())}/{d.numel()}", flush=True)
    if not torch.isfinite(outs["cuda"]).all() or float(d.max()) > MODEL_TOL:
        fail(f"model f32 CUDA vs CPU beyond {MODEL_TOL:g}")

    # (b) the published frame through the whole-image function, bf16
    model = build_model_and_params(ModelConfig(), pth, torch.device("cuda"))
    run = make_whole_image_fn(
        lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
        FRAME[0], FRAME[1], ps=128, square=False, device="cuda")
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)
    run(frame)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        y = run(frame)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / reps
    counts = read_counts()
    k1, k2 = counts["k1_fwd_tc"], counts["k2"]
    ok = bool(torch.isfinite(y).all()) and float(y.min()) >= 0.0 \
        and float(y.max()) <= 1.0
    mpix = FRAME[0] * FRAME[1] / 1e6
    print(f"whole image {FRAME[0]}x{FRAME[1]} rect canvas 1280x1664 bf16: "
          f"{secs:.4f} s/frame {mpix / secs:.3f} Mpix/s "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"launches over {reps} frames K1 (tensor cores)={k1} K1 (CUDA "
          f"cores)={counts['k1_fwd']} K2={k2} "
          f"out shape {tuple(y.shape)} range [{float(y.min()):.4f}, "
          f"{float(y.max()):.4f}]", flush=True)
    if tuple(y.shape) != (1,) + FRAME + (3,) or not ok:
        fail("whole-image output has the wrong shape or leaves [0, 1]")
    if k1 != 18 * reps or counts["k1_fwd"] or k2 != 18 * reps:
        fail("the whole-image forward did not launch K1's tensor-core "
             "forward and K2 18 times each per frame")
    _profile(f"one {FRAME[0]}x{FRAME[1]} serving frame on the rect canvas, "
             "bf16", lambda: run(frame), 1, secs * 1e3)
    return pth


def phase_model_pad(pth: str):
    """Uformer-32 with a padding mask: a 200×240 image centred on the 256²
    canvas (infer.anyres), f32 with TF32 off, the CUDA forward (kernels)
    against the CPU forward (twins), same weights and sampling seed."""
    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.anyres import expand2square

    x = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
        size=(1, 200, 240, 3)).astype(np.float32))
    canvas, pad, _ = expand2square(x, 128)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model_and_params(ModelConfig(dtype=torch.float32), pth,
                                       torch.device(dev))
        reset_counts()
        with torch.inference_mode():
            outs[dev] = model(canvas.to(dev), pad_mask=pad.to(dev),
                              generator=torch.Generator().manual_seed(SEED)
                              ).cpu()
    k1 = read_counts()["k1_fwd_f32"]
    d = (outs["cuda"] - outs["cpu"]).abs()
    print(f"model with padding mask, 200x240 on the {canvas.shape[1]}² "
          f"canvas, f32 CUDA vs CPU: max|d|={float(d.max()):.3e} "
          f"mean|d|={float(d.mean()):.3e}; K1 launches {k1}", flush=True)
    if not torch.isfinite(outs["cuda"]).all() or float(d.max()) > MODEL_TOL:
        fail(f"model with padding mask: CUDA vs CPU beyond {MODEL_TOL:g}")
    if k1 != 18:
        fail("the padded forward did not run K1's float32 kernel 18 times")


FRAME_F32_REPS = 2


def phase_frame_f32(pth: str):
    """The 1200×1600 frame through the whole-image function in float32
    (rect canvas 1280×1664, TF32 off), the evaluators' frame at the
    reference's own precision: s/frame, 18 launches of K1's float32
    forward and of K2 (its 3xTF32 classes) per frame and nothing else, no
    twin call, output finite and in [0, 1]. Returns its launch counts (the
    float32 kernels' path)."""
    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn

    model = build_model_and_params(ModelConfig(dtype=torch.float32), pth,
                                   torch.device("cuda"))
    run = make_whole_image_fn(
        lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
        FRAME[0], FRAME[1], ps=128, square=False, device="cuda")
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)
    run(frame)
    torch.cuda.synchronize()
    reset_counts()
    with _TwinCounts() as twins:
        t0 = time.perf_counter()
        for _ in range(FRAME_F32_REPS):
            y = run(frame)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / FRAME_F32_REPS
    counts = {**read_counts(), **twins}
    n = FRAME_F32_REPS
    print(f"whole image {FRAME[0]}x{FRAME[1]} rect canvas 1280x1664 f32: "
          f"{secs:.4f} s/frame; launches per frame K1 f32 "
          f"{counts['k1_fwd_f32'] / n:g} K2 {counts['k2'] / n:g}, K1 "
          f"tensor cores {counts['k1_fwd_tc'] / n:g} CUDA cores "
          f"{counts['k1_fwd'] / n:g}, twin calls K1 {twins['twin_k1']} K2 "
          f"{twins['twin_k2']}", flush=True)
    want = {k: 0 for k in counts}
    want.update(k1_fwd_f32=18 * n, k2=18 * n)
    if counts != want:
        fail(f"the float32 frame's launches {counts}, want {want}")
    if not bool(torch.isfinite(y).all()) or float(y.min()) < 0.0 \
            or float(y.max()) > 1.0 or tuple(y.shape) != (1,) + FRAME + (3,):
        fail("the float32 frame has the wrong shape or leaves [0, 1]")
    return counts


def _write_eval_folders(tmp: str):
    """Three 1200×1600 pairs for test_long; for test_anyres two of them and
    a 1000×1500 pair (neither side a multiple of 128)."""
    import shutil

    from dehaze_tpu_torch.data.synth import write_dataset

    long_dir = os.path.join(tmp, "eval_long")
    any_dir = os.path.join(tmp, "eval_anyres")
    odd_dir = os.path.join(tmp, "eval_odd")
    write_dataset(long_dir, 3, FRAME, seed=5)
    write_dataset(odd_dir, 1, (1000, 1500), seed=6)
    for sub in ("gt", "hazy"):
        os.makedirs(os.path.join(any_dir, sub))
        for i in range(2):
            shutil.copy(os.path.join(long_dir, sub, f"{i:05d}.png"),
                        os.path.join(any_dir, sub))
        shutil.copy(os.path.join(odd_dir, sub, "00000.png"),
                    os.path.join(any_dir, sub, "00002.png"))
    return long_dir, any_dir


def phase_eval(tmp: str, pth: str):
    """The evaluation path at full width (Uformer-32, bf16, the seeded
    .pth): `python -m dehaze_tpu_torch.cli.test_long` on three 1200×1600
    pairs (square canvas 1664², then --rect_canvas) and
    `python -m dehaze_tpu_torch.cli.test_anyres` on two of them and a
    1000×1500 pair (phase_data's folders), one after another in a
    subprocess, each with every launch count at 0 (_counted_clis);
    s/frame, launches per frame and peak device memory; each
    per-image PSNR against the in-process function with the same weights
    and seed. Returns the launches of the three runs together and the
    per-image PSNRs of the test_long runs by canvas ("square", "rect")."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images
    from dehaze_tpu_torch.infer.anyres import make_anyres_fn
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.ops import metrics as M

    long_dir = os.path.join(tmp, "eval_long")
    any_dir = os.path.join(tmp, "eval_anyres")
    model = build_model_and_params(ModelConfig(), pth, torch.device("cuda"))

    def apply_fn(x, pad_mask=None):
        return model(x, generator=torch.Generator().manual_seed(SEED),
                     pad_mask=pad_mask)

    runs = [("test_long", long_dir, [], "square canvas 1664²"),
            ("test_long", long_dir, ["--rect_canvas"],
             "rect canvas 1280x1664"),
            ("test_anyres", any_dir, [], "any-resolution, 1664² and 1536²")]
    total, psnrs = {}, {}
    done, secs = _counted_clis([
        (cli, ["--input_dir", folder, "--weights", pth, "--seed", SEED,
               "--result_dir", os.path.join(tmp, f"res_{cli}")] + extra,
         " ".join(extra)) for cli, folder, extra, _ in runs])
    for (cli, folder, extra, what), (out, stats) in zip(runs, done):
        if stats["rc"] != 0:
            fail(f"cli.{cli} {' '.join(extra)} exited {stats['rc']}")
        lines = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out, re.M)
        per_frame = float(re.search(r"frames: (\S+) s/frame", out).group(1))
        n = len(lines)
        # the same frames through the in-process function; the second call
        # of each is timed (the frame already on the card)
        worst, fns, timed = 0.0, {}, {}
        for (name, psnr, _), (clean, hazy, fname) in zip(
                lines, val_images(PairedFolder(folder))):
            h, w = hazy.shape[:2]
            if (h, w) not in fns:
                fns[(h, w)] = (make_anyres_fn(apply_fn, h, w, 128)
                               if cli == "test_anyres" else
                               make_whole_image_fn(apply_fn, h, w, 128,
                                                   square=not extra))
            x = torch.from_numpy(hazy[None]).cuda()
            y = fns[(h, w)](x)[0]
            if not torch.isfinite(y).all() or name != fname:
                fail(f"cli.{cli}: {fname} gives a non-finite output")
            ref = M.psnr(y, torch.from_numpy(clean).cuda())
            worst = max(worst, abs(float(ref) - float(psnr)))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fns[(h, w)](x)
            torch.cuda.synchronize()
            timed.setdefault(f"{h}x{w}", []).append(time.perf_counter() - t1)
        print("  in-process s/frame by frame size: " + ", ".join(
            f"{k} {np.mean(v):.4f}" for k, v in timed.items()), flush=True)
        if cli == "test_long" and not extra:
            x = torch.from_numpy(hazy[None]).cuda()
            _profile(f"one {h}x{w} frame on the square canvas, bf16",
                     lambda: fns[(h, w)](x), 1, np.mean(timed[f"{h}x{w}"])
                     * 1e3)
        print(f"cli.{cli} {what} Uformer-32 bf16: {n} frames, "
              f"{per_frame:.4f} s/frame after the first, launches per frame "
              f"K1 tensor cores {stats['k1_fwd_tc'] / n:g} CUDA cores "
              f"{stats['k1_fwd'] / n:g} K2 {stats['k2'] / n:g}, peak "
              f"device memory {stats['peak_gib']:.2f} GiB, run "
              f"{stats['secs']:.1f}s (the three in one process "
              f"{secs:.1f}s); per-image PSNR vs the in-process function: "
              f"max |d| {worst:.2e} dB", flush=True)
        if n != 3 or not all(np.isfinite(float(p)) for _, p, _ in lines):
            fail(f"cli.{cli}: expected 3 finite per-image lines")
        _check_launches(f"cli.{cli} {' '.join(extra)}", stats, n)
        if worst > EVAL_PSNR_TOL:
            fail(f"cli.{cli}: per-image PSNR differs from the in-process "
                 f"function by {worst:.2e} dB")
        for key in ("k1_fwd", "k1_fwd_tc", "k2"):
            total[key] = total.get(key, 0) + stats[key]
        if cli == "test_long":
            psnrs["rect" if extra else "square"] = [float(p)
                                                    for _, p, _ in lines]
    return total, psnrs


def phase_serve(pth: str):
    import numpy as np
    from http.server import ThreadingHTTPServer

    from dehaze_tpu_torch.cli.serve import (build_dehaze_fn, build_parser,
                                            make_handler, warm_up)
    from dehaze_tpu_torch.cli.common import config_from_args
    from dehaze_tpu_torch.data.images import decode_img, encode_img

    reset_counts()
    args = build_parser().parse_args(
        ["--weights", pth, "--port", "0", "--seed", str(SEED),
         "--precompile", f"{FRAME[0]}x{FRAME[1]}"])
    dehaze, info = build_dehaze_fn(args, config_from_args(args).model)
    print(f"serve warm-up {args.precompile}: "
          f"{warm_up(dehaze, info, args.precompile):.2f}s", flush=True)
    srv = ThreadingHTTPServer((args.host, 0), make_handler(dehaze, info))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{srv.server_port}"
    bodies = [encode_img(_textured_frame(SEED + i)) for i in range(3)]

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(url + "/dehaze", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            status, out = r.status, r.read()
        return status, out, time.perf_counter() - t0

    try:
        results = [post(bodies[0])]
        with cf.ThreadPoolExecutor(2) as ex:
            results += list(ex.map(post, bodies[1:]))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        dehaze.batcher.close()
    counts = read_counts()
    k1, k2 = counts["k1_fwd_tc"], counts["k2"]
    for i, (status, out, secs) in enumerate(results):
        shape = decode_img(out, u8=True).shape if status == 200 else None
        print(f"request {i}: status {status} latency {secs:.3f}s "
              f"png shape {shape}", flush=True)
        if status != 200 or shape != FRAME + (3,):
            fail(f"request {i} failed")
    print(f"healthz: served={health['served']} batch_hist="
          f"{health['batch_hist']}; launches during serving K1={k1} K2={k2}",
          flush=True)
    if (health["served"] != 3 or k1 == 0 or k2 == 0 or k1 != k2
            or counts["k1_fwd"]):
        fail("serving did not run through K1's tensor-core forward and K2 "
             "alike")
    return counts



# A subprocess that runs port CLIs one after another, each through the
# `main(argv)` that `python -m dehaze_tpu_torch.cli.<cli>` calls, with
# every launch count, the plain twins' calls and the peak memory reset
# before each. argv[1]: JSON [[cli, [args...]], ...]. Each run's output
# follows a `RUN i` line and ends with `STATS i {counts, rc, secs,
# peak_gib}`. Started as the ranks of a process group (the variables
# torchrun sets), the group the first CLI joins serves the next ones and
# is shut down at the end. One process for several runs saves each its
# start (~8 s: torch, CUDA, the kernels' libraries).
_RUNNER = r'''
import importlib, json, sys, time, torch
from dehaze_tpu_torch.ops import probsparse as ps
from dehaze_tpu_torch.ops.kernels import leff, window_attention as wa
from dehaze_tpu_torch.parallel import dist
twins = {"twin_k1": 0, "twin_k2": 0}
def counted(fn, key):
    def call(*a, **kw):
        twins[key] += 1
        return fn(*a, **kw)
    return call
ps.probsparse_attention_bnc = counted(ps.probsparse_attention_bnc, "twin_k1")
leff.leff_reference = counted(leff.leff_reference, "twin_k2")
kern = {"k1_fwd_tc": (wa.window_attention_fwd, "launches_tc"),
        "k1_fwd": (wa.window_attention_fwd, "launches"),
        "k1_bwd_tc": (wa.window_attention_bwd, "launches_tc"),
        "k1_bwd": (wa.window_attention_bwd, "launches"),
        "k2": (leff.leff_fused, "launches")}
for v in ("v1", "v2"):
    fn = getattr(wa, "probsparse_window_attention_" + v)
    kern["k3_" + v + "_tc"] = (fn, "launches_tc")
    kern["k3_" + v] = (fn, "launches")
for d in ("fwd", "bwd"):
    fn = getattr(wa, "window_attention_v3_" + d)
    kern["k3_v3_" + d + "_tc"] = (fn, "launches_tc")
    kern["k3_v3_" + d] = (fn, "launches")
for i, (cli, args) in enumerate(json.loads(sys.argv[1])):
    for fn, attr in kern.values():
        setattr(fn, attr, 0)
    for k in twins:
        twins[k] = 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    print(f"RUN {i}", flush=True)
    t0 = time.perf_counter()
    try:
        out = importlib.import_module("dehaze_tpu_torch.cli." + cli).main(args)
        rc = out if type(out) is int else 0
    except SystemExit as e:
        rc = e.code if type(e.code) is int else int(e.code is not None)
        if type(e.code) is str:
            print(e.code, file=sys.stderr, flush=True)
    stats = {k: getattr(fn, a) for k, (fn, a) in kern.items()}
    stats.update(twins, rc=rc, secs=time.perf_counter() - t0,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30
                 if torch.cuda.is_available() else 0.0)
    print(f"STATS {i} " + json.dumps(stats), flush=True)
dist.shutdown()
'''


def _split_runs(out: str):
    """[(stdout, stats)] of each run in a _RUNNER's output, in order."""
    runs, cur = {}, None
    for ln in out.splitlines():
        if ln.startswith("RUN "):
            cur = int(ln.split()[1])
            runs[cur] = [[], None]
        elif ln.startswith("STATS "):
            _, i, js = ln.split(" ", 2)
            runs[int(i)][1] = json.loads(js)
            cur = None
        elif cur is not None:
            runs[cur][0].append(ln)
    return [("\n".join(lines), stats) for lines, stats in
            (runs[i] for i in sorted(runs))]


def _counted_clis(runs, timeout: int = 900, script: str = _RUNNER):
    """`runs` [(cli, args, label)] in one subprocess (`script`, _RUNNER
    or a variant): ([(stdout, counts)] of each run in order, the
    process's seconds). Each run's lines are echoed as `cli.<cli> <label>
    | line`; a process that fails fails the smoke, and the callers check
    each run's exit code."""
    spec = json.dumps([[cli, [str(a) for a in args]] for cli, args, _ in
                       runs])
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", script, spec],
                       capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": REPO})
    secs = time.perf_counter() - t0
    res = _split_runs(r.stdout)
    for (cli, _, label), (out, _) in zip(runs, res):
        for ln in out.splitlines():
            print(f"  cli.{cli} {label} | {ln}", flush=True)
    if r.returncode != 0 or len(res) != len(runs) or any(
            st is None for _, st in res):
        fail(f"the CLI runs {[f'{c} {lb}' for c, _, lb in runs]} exited "
             f"{r.returncode}: {r.stderr[-3000:]}")
    return res, secs


def _check_launches(label: str, stats: dict, frames: int, k1: int = 18,
                    k2: int = 18):
    """`k1` K1 tensor-core forward (18, 0 for a W-MSA model, 36 for a frame
    in two bands) and `k2` K2 launches (18, or 0 on the banded path) per
    frame, no CUDA-core K1 forward and no twin call."""
    want = (k1 * frames, 0, k2 * frames, 0, 0)
    got = tuple(stats.get(k, 0) for k in ("k1_fwd_tc", "k1_fwd", "k2",
                                          "twin_k1", "twin_k2"))
    if got != want:
        fail(f"{label}: launches (K1 tensor cores, K1 CUDA cores, K2, K1 "
             f"twin, K2 twin) {got}, want {want} for {frames} frames")


class _TwinCounts:
    """Counts the calls of the plain twins of K1 and K2 in this process
    while it is entered (the operators' CPU kernels call them)."""

    def __enter__(self):
        from dehaze_tpu_torch.ops import probsparse as ps
        from dehaze_tpu_torch.ops.kernels import leff

        self.calls = {"twin_k1": 0, "twin_k2": 0}
        self.saved = []
        for mod, name, key in ((ps, "probsparse_attention_bnc", "twin_k1"),
                               (leff, "leff_reference", "twin_k2")):
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def call(*a, _fn=fn, _key=key, **kw):
                self.calls[_key] += 1
                return _fn(*a, **kw)

            setattr(mod, name, call)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_serving(tmp: str, pth: str, eval_psnrs):
    """The serving slice on the seeded Uformer-32 `.pth`, bf16. First, one
    after another in one subprocess (_counted_clis): `cli.export` on the
    card (rect canvas 1200×1600), `cli.stream` with --weights on
    STREAM_FRAMES synthetic 1200×1600 PNG frames and one 1000×1500, then
    with --exported on the 1200×1600 ones, `cli.test_long --exported` on
    phase 9's three pairs, and `cli.export --square` with `cli.test_long
    --exported` on that square artifact. Then:
    (a) that artifact and one traced in-process on the CPU, both loaded
        onto the card: each equal to the eager CUDA forward of the same
        seed bit for bit, 18 K1 tensor-core and 18 K2 launches per frame
        and no twin call; artifact MB, export s, artifact and eager
        ms/frame in turns;
    (b) each stream output equal to the in-process quantized forward;
        s/frame, Mpix/s, the decode and encode ms of a frame and the
        in-process forward's, and the stage that sets the pace;
    (c) the `test_long --exported` PSNRs equal to the --weights run's
        within EVAL_PSNR_TOL on each canvas: the rect artifact against
        --rect_canvas, the square one (the protocol's 1664² canvas, 18 K1
        and 18 K2 launches per frame) against the square run;
    (d) the serving CLI's machinery with --exported and --precompile auto:
        a request at the baked geometry (200, the eager forward's pixels)
        and one of another (400); /healthz.
    Returns the launches of each path: stream, stream_exported,
    eval_exported, eval_exported_square, serve_exported."""
    import re
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import (build_model_and_params,
                                             config_from_args)
    from dehaze_tpu_torch.cli.serve import (build_dehaze_fn, build_parser,
                                            make_handler, warm_up)
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.images import (decode_img, encode_img,
                                              load_img, save_img)
    from dehaze_tpu_torch.infer.export import (WholeImage,
                                               export_whole_image_bytes,
                                               load_exported, save_exported)
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
    from dehaze_tpu_torch.models.uformer import draw_sample_tables

    def ms_per(fn, reps=3):  # host clock around synchronised calls
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    # the CLIs, in one process
    rect = os.path.join(tmp, "rect.dhz")
    sq = os.path.join(tmp, "square.dhz")
    long_dir = os.path.join(tmp, "eval_long")
    sw, sx = os.path.join(tmp, "stream_w"), os.path.join(tmp, "stream_x")
    os.makedirs(sw)
    os.makedirs(sx)
    for i in range(STREAM_FRAMES):
        save_img(os.path.join(sw, f"{i:02d}.png"), _textured_frame(100 + i))
        shutil.copy(os.path.join(sw, f"{i:02d}.png"), sx)
    save_img(os.path.join(sw, "odd.png"), _textured_frame(108, (1000, 1500)))
    streams = (("--weights", sw, ["--weights", pth, "--seed", SEED],
                STREAM_FRAMES + 1, True),
               ("--exported", sx, ["--exported", rect], STREAM_FRAMES,
                False))
    done, cli_secs = _counted_clis(
        [("export", ["--weights", pth, "--seed", SEED, "--height",
                     FRAME[0], "--width", FRAME[1], "--out", rect], "rect")]
        + [("stream", ["--input_dir", src, "--result_dir",
                       os.path.join(tmp, f"res_stream{label}")] + flag,
            label) for label, src, flag, _, _ in streams]
        + [("test_long", ["--input_dir", long_dir, "--exported", rect,
                          "--result_dir",
                          os.path.join(tmp, "res_long_exported")],
            "--exported"),
           ("export", ["--weights", pth, "--seed", SEED, "--square",
                       "--out", sq], "--square"),
           ("test_long", ["--input_dir", long_dir, "--exported", sq,
                          "--result_dir",
                          os.path.join(tmp, "res_long_exported_sq")],
            "--exported (square)")])
    for (out, stats), what in zip(done, ("export", "stream --weights",
                                         "stream --exported",
                                         "test_long --exported",
                                         "export --square",
                                         "test_long --exported (square)")):
        if stats["rc"] != 0:
            fail(f"cli.{what} exited {stats['rc']}")
    print(f"the serving CLIs in one process: {cli_secs:.1f}s", flush=True)

    # (a) the artifacts
    out = done[0][0]
    m = re.search(r"\((\S+) MB, traced on (cuda\S*) in (\S+)s\)", out)
    if not m:
        fail("cli.export did not trace on the card")
    rect_mb, rect_s = float(m.group(1)), float(m.group(3))
    cpu_model = build_model_and_params(ModelConfig(), pth,
                                       torch.device("cpu"))
    tables = draw_sample_tables(cpu_model,
                                torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    blob = export_whole_image_bytes(
        WholeImage(cpu_model, tables, *FRAME, 128, False), *FRAME, "cpu")
    cpu_s = time.perf_counter() - t0
    cpu_art = os.path.join(tmp, "cpu_traced.dhz")
    save_exported(cpu_art, blob, {"arch": "uformer", "height": FRAME[0],
                                  "width": FRAME[1]})
    del cpu_model, blob
    model = build_model_and_params(ModelConfig(), pth, torch.device("cuda"))

    def apply_fn(x):
        return model(x, generator=torch.Generator().manual_seed(SEED))

    eager = make_whole_image_fn(apply_fn, *FRAME, 128, square=False,
                                device="cuda")
    frame = _textured_frame(SEED + 20)
    x = torch.from_numpy(frame.astype(np.float32) / 255.0)[None].cuda()
    want = eager(x)
    for what, path, mb, secs in (
            ("cli.export, traced on the card", rect, rect_mb, rect_s),
            ("traced on the CPU, moved to the card", cpu_art,
             os.path.getsize(cpu_art) / 1e6, cpu_s)):
        fn, _ = load_exported(path, "cuda")
        fn(x)
        torch.cuda.synchronize()
        reset_counts()
        with _TwinCounts() as twins:
            got = fn(x)
            torch.cuda.synchronize()
        counts = {**read_counts(), **twins}
        d = (got.float() - want.float()).abs()
        times = [ms_per(lambda: fn(x), 5), ms_per(lambda: eager(x), 5),
                 ms_per(lambda: eager(x), 5), ms_per(lambda: fn(x), 5)]
        print(f"artifact {what}: {mb:.1f} MB, export {secs:.1f}s; "
              f"{FRAME[0]}x{FRAME[1]} rect canvas bf16 against the eager "
              f"CUDA forward (seed {SEED}): equal {torch.equal(got, want)}, "
              f"max|d| {float(d.max()):.3e}, values differing "
              f"{int((d > 0).sum())}; launches per frame K1 tensor cores "
              f"{counts['k1_fwd_tc']} CUDA cores {counts['k1_fwd']} K2 "
              f"{counts['k2']}, twin calls K1 {twins['twin_k1']} K2 "
              f"{twins['twin_k2']}; ms/frame artifact, eager, eager, "
              f"artifact: {', '.join(f'{t:.2f}' for t in times)}",
              flush=True)
        _check_launches(f"artifact {what}", counts, 1)
        if not torch.equal(got, want):
            fail(f"artifact {what} differs from the eager CUDA forward")
        del fn

    # (b) cli.stream, --weights then --exported
    runs = {}

    def check_outputs(label, src, res, u8):
        for name in sorted(os.listdir(src)):
            img = load_img(os.path.join(src, name), u8=u8)
            h, w = img.shape[:2]
            run = runs.setdefault((h, w, u8), quantize_u8(
                make_whole_image_fn(apply_fn, h, w, 128, square=False,
                                    device="cuda")))
            ref = run(img[None])[0].cpu().numpy()
            got = load_img(os.path.join(res, name), u8=True)
            if not np.array_equal(got, ref):
                fail(f"cli.stream {label}: {name} differs from the "
                     f"in-process forward in {int((got != ref).sum())} "
                     "values")

    stream = {}
    for (label, src, _, n_frames, u8), (out, stats) in zip(streams,
                                                          done[1:3]):
        res = os.path.join(tmp, f"res_stream{label}")
        secs = stats["secs"]
        m = re.search(r"(\d+) frames in (\S+)s = (\S+) Mpix/s", out)
        if not m or int(m.group(1)) != n_frames:
            fail(f"cli.stream {label}: no summary line for {n_frames} "
                 "frames")
        check_outputs(label, src, res, u8)
        _check_launches(f"cli.stream {label}", stats, n_frames)
        stream[label] = (float(m.group(2)) / n_frames, float(m.group(3)),
                         secs, stats)
    first = os.path.join(sw, "00.png")
    dec_ms = ms_per(lambda: load_img(first, u8=True))
    body = load_img(first, u8=True)
    out_u8 = load_img(os.path.join(tmp, "res_stream--weights", "00.png"),
                      u8=True)
    enc_ms = ms_per(lambda: encode_img(out_u8))
    fwd_ms = ms_per(lambda: runs[FRAME + (True,)](body[None]).cpu())
    pace = {"decode (2 workers)": dec_ms / 2, "forward": fwd_ms,
            "encode (2 workers)": enc_ms / 2}
    for label, (spf, mpix, secs, _) in stream.items():
        print(f"cli.stream {label} Uformer-32 bf16 rect canvas: {spf:.4f} "
              f"s/frame, {mpix:.3f} Mpix/s sustained (run {secs:.1f}s); "
              "outputs equal to the in-process quantized forward",
              flush=True)
    print(f"stream stages at {FRAME[0]}x{FRAME[1]} (same call): decode "
          f"{dec_ms:.1f} ms, in-process forward (to the host) {fwd_ms:.1f} "
          f"ms, PNG encode {enc_ms:.1f} ms per frame; with 2 decode and 2 "
          f"encode workers the slowest stage is {max(pace, key=pace.get)} "
          f"({max(pace.values()):.1f} ms/frame)", flush=True)

    # (c) test_long --exported on the rect and on the square artifact
    eval_exported = {}
    for (out, stats), canvas, what in (
            (done[3], "rect", "rect artifact, 1280x1664 canvas"),
            (done[5], "square", "square artifact, 1664² canvas")):
        psnrs = [float(p) for p in re.findall(r"^\S+: PSNR (\S+) SSIM",
                                               out, re.M)]
        worst = max((abs(a - b) for a, b in zip(psnrs, eval_psnrs[canvas])),
                    default=math.inf)
        per_frame = float(re.search(r"frames: (\S+) s/frame", out).group(1))
        print(f"cli.test_long --exported ({what}): {len(psnrs)} frames, "
              f"{per_frame:.4f} s/frame after the first, per-image PSNR vs "
              f"--weights on the {canvas} canvas max |d| {worst:.2e} dB, "
              f"run {stats['secs']:.1f}s", flush=True)
        if len(psnrs) != 3 or worst > EVAL_PSNR_TOL:
            fail(f"cli.test_long --exported ({canvas}): PSNRs differ from "
                 "--weights")
        _check_launches(f"cli.test_long --exported ({canvas})", stats, 3)
        eval_exported[canvas] = stats

    # (d) serve --exported
    args = build_parser().parse_args(["--exported", rect, "--port", "0",
                                      "--precompile", "auto"])
    dehaze, info = build_dehaze_fn(args, config_from_args(args).model)
    print(f"serve --exported warm-up (auto, {info['geometry']}): "
          f"{warm_up(dehaze, info, 'auto'):.2f}s", flush=True)
    srv = ThreadingHTTPServer((args.host, 0), make_handler(dehaze, info))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://{args.host}:{srv.server_port}"

    def post(img):
        req = urllib.request.Request(url + "/dehaze", method="POST",
                                     data=encode_img(img))
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    reset_counts()
    try:
        with _TwinCounts() as twins:
            t0 = time.perf_counter()
            status, answer = post(frame)
            latency = time.perf_counter() - t0
            other = post(_textured_frame(7, (1000, 1500)))
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        dehaze.batcher.close()
    serve_exported = {**read_counts(), **twins}
    ref = quantize_u8(eager)(x)[0].cpu().numpy()
    same = status == 200 and np.array_equal(decode_img(answer, u8=True), ref)
    print(f"serve --exported: request {FRAME[0]}x{FRAME[1]} status {status} "
          f"latency {latency:.3f}s, equal to the eager forward {same}; "
          f"1000x1500 request status {other[0]} ({other[1][:80]!r}); "
          f"healthz max_batch {health['max_batch']} served "
          f"{health['served']}", flush=True)
    if not same or other[0] != 400 or health["max_batch"] != 1:
        fail("serve --exported: wrong answer, no 400 for another "
             "geometry, or micro-batching on")
    _check_launches("serve --exported", serve_exported, 1)
    return {"stream": stream["--weights"][3],
            "stream_exported": stream["--exported"][3],
            "eval_exported": eval_exported["rect"],
            "eval_exported_square": eval_exported["square"],
            "serve_exported": serve_exported}


def _grad_check(name, gc, gg, rtol_of, atol):
    """Compare gradient leaves {name: tensor}: ||Δ|| <= rtol·||ref|| +
    atol·sqrt(numel), rtol per leaf from rtol_of(name). Prints the worst
    relative error by leaf kind; returns the leaves beyond."""
    rel, bad, kinds = {}, [], {}
    for k in gc:
        d, r = float((gg[k] - gc[k]).norm()), float(gc[k].norm())
        rel[k] = d / max(r, 1e-30)
        if d > rtol_of(k) * r + atol * gc[k].numel() ** 0.5:
            bad.append(k)
        kind = k.split(".blocks.")[-1].split(".", 1)[-1]
        kinds[kind] = max(kinds.get(kind, 0.0), rel[k])
    print(f"  {name}: {len(rel)} gradient leaves, median rel "
          f"{sorted(rel.values())[len(rel) // 2]:.2e}, beyond tolerance "
          f"{len(bad)}; worst rel by leaf kind: " + ", ".join(
              f"{k} {v:.1e}" for k, v in sorted(kinds.items())), flush=True)
    return bad


def phase_train_parity():
    """CUDA (kernels) against CPU (twins), f32, TF32 off, same weights and
    sampling tables (one seeded CPU generator each), drop_path 0:
    (a) the model's backward for one fixed output gradient; (b) one train
    step with Charbonnier + CR loss on the fixed-seed random VGG19."""
    import warnings

    import numpy as np
    import torch

    from dehaze_tpu_torch.config import (Config, DataConfig, LossConfig,
                                         ModelConfig, TrainConfig)
    from dehaze_tpu_torch.train.trainer import Trainer, build_model

    # noise images: the smooth synthetic scenes have flat regions whose
    # windows hold near-identical tokens, and there a one-ulp difference
    # between cuBLAS and the CPU reorders near-tied sparsity measures and
    # flips rows between attention and mean(V) (a change of selection, not
    # an error of either device)
    rng = np.random.default_rng(SEED)
    clean = rng.integers(0, 256, size=(2, TRAIN_PS, TRAIN_PS, 3),
                         dtype=np.uint8)
    hazy = (clean * 0.6 + rng.integers(0, 100, size=clean.shape)).astype(
        np.uint8)
    cfg = Config(model=ModelConfig(dtype=torch.float32, drop_path_rate=0.0),
                 loss=LossConfig(w_contrast=1.0),
                 data=DataConfig(batch_size=2), train=TrainConfig(seed=SEED))
    x = torch.from_numpy(hazy).float() / 255.0
    cot = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=x.shape).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev).train()
        y = model(x.to(dev), generator=torch.Generator().manual_seed(SEED))
        (y * cot.to(dev)).sum().backward()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    bad = _grad_check("model backward (fixed output gradient)",
                      grads["cpu"], grads["cuda"],
                      lambda k: STEP_TOL["model"], STEP_TOL["atol"])
    if bad:
        fail(f"model backward gradients {bad[:4]}: CUDA and CPU disagree")

    out = {}
    for dev in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-VGG19 warning
            tr = Trainer(cfg, steps_per_epoch=1, device=dev)
        t0 = time.perf_counter()
        m = tr.train_step(clean, hazy, use_mixup=False)
        out[dev] = (float(m["loss"]), time.perf_counter() - t0,
                    {k: p.grad.detach().cpu() for k, p in
                     tr.model.named_parameters()})
    (lc, tc, gc), (lg, tg, gg) = out["cpu"], out["cuda"]
    score_fed = ("query_projection", "key_projection",
                 "relative_position_bias_table")
    bad = _grad_check(
        "train step (Charbonnier + CR)", gc, gg,
        lambda k: STEP_TOL["step_scores" if any(s in k for s in score_fed)
                           else "step"], STEP_TOL["atol"])
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"train step Uformer-32 b2x{TRAIN_PS}² f32 Charbonnier + CR, CUDA "
          f"vs CPU: loss {lg:.7f} vs {lc:.7f} (rel {loss_rel:.2e}); step "
          f"{tg:.2f}s CUDA, {tc:.2f}s CPU", flush=True)
    if not math.isfinite(lg) or loss_rel > STEP_TOL["loss"]:
        fail("train step loss: CUDA and CPU disagree")
    if bad:
        fail(f"train step gradients {bad[:4]}: CUDA and CPU disagree")


N_TRAIN, N_VAL = 256, 32


def phase_data(tmp: str):
    """The synthetic data of the later phases: phase 9's evaluation pairs
    (`_write_eval_folders`) and phase 11's training set, which the later
    training phases share."""
    from dehaze_tpu_torch.data.synth import write_dataset

    t0 = time.perf_counter()
    _write_eval_folders(tmp)
    write_dataset(os.path.join(tmp, "train"), N_TRAIN, 256, seed=1)
    write_dataset(os.path.join(tmp, "val"), N_VAL, TRAIN_PS, seed=2)
    print(f"synthetic data: 3 eval pairs at {FRAME[0]}x{FRAME[1]}, 1 at "
          f"1000x1500; {N_TRAIN} train pairs at 256², {N_VAL} val pairs at "
          f"{TRAIN_PS}², in {time.perf_counter() - t0:.1f}s", flush=True)


def phase_train_cli(tmp: str):
    """The training path through its CLI entry point on phase_data's
    synthetic pairs."""
    return _train_cli(tmp, "_smoke", [])


def _train_cli(tmp: str, env: str, extra, wmsa: bool = False,
               train_dir: str = "", rank_env: bool = False):
    """`cli.train` with `extra` flags in a subprocess that starts with
    every launch count at 0 and prints them at its end: losses, launch
    counts per step, checkpoints, the reload of model_best.pth. `wmsa`:
    the W-MSA model (extra holds --attention full), which launches no K1.
    train_dir: phase 11's set unless given. rank_env: run it as the one
    rank of a process group (the variables torchrun sets). Returns (launch
    counts, the epoch event)."""
    import glob

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.pipeline import PairedFolder, _val_batches
    from dehaze_tpu_torch.ops import metrics as M
    from dehaze_tpu_torch.train.checkpoint import load_checkpoint

    train_dir = train_dir or os.path.join(tmp, "train")
    n_train = len(os.listdir(os.path.join(train_dir, "gt")))
    n_val = N_VAL
    code = ("import json, sys\n"
            "from dehaze_tpu_torch.cli import train\n"
            "train.main(sys.argv[1:])\n"
            "from dehaze_tpu_torch.ops.kernels import leff, window_attention "
            "as wa\n"
            "print('LAUNCHES ' + json.dumps({'k1_fwd': "
            "wa.window_attention_fwd.launches, 'k1_fwd_tc': "
            "wa.window_attention_fwd.launches_tc, 'k1_bwd': "
            "wa.window_attention_bwd.launches, 'k1_bwd_tc': "
            "wa.window_attention_bwd.launches_tc, 'k2': "
            "leff.leff_fused.launches}))\n")
    save = os.path.join(tmp, "log")
    args = ["--train_dir", train_dir,
            "--val_dir", os.path.join(tmp, "val"),
            "--train_ps", str(TRAIN_PS), "--batch_size", str(TRAIN_BATCH),
            "--embed_dim", "32", "--dtype", "bfloat16", "--nepoch", "1",
            "--w_loss_vgg7", "1", "--save_dir", save, "--env", env] + extra
    what = " ".join(["cli.train"] + extra)
    t0 = time.perf_counter()
    group = ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
              "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
             if rank_env else {})
    r = subprocess.run([sys.executable, "-c", code] + args,
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": REPO, **group})
    secs = time.perf_counter() - t0
    for ln in r.stdout.splitlines():
        if ln.startswith(("Input & GT", "[Ep", "Epoch", "best", "==>")):
            print(f"  {what} | {ln}", flush=True)
    if r.returncode != 0:
        fail(f"{what} exited {r.returncode}: {r.stderr[-3000:]}")
    counts = json.loads(r.stdout.split("LAUNCHES ")[-1].splitlines()[0])
    log_dir = os.path.join(save, "uformer" + env)
    events = [json.loads(ln) for f in glob.glob(os.path.join(log_dir,
                                                             "*.jsonl"))
              for ln in open(f)]
    epoch = next(e for e in events if e["kind"] == "epoch")
    evals = [e for e in events if e["kind"] == "eval"]
    losses = epoch["step_losses"]
    steps = n_train // TRAIN_BATCH
    val_batches = -(-n_val // TRAIN_BATCH)
    k1 = 0 if wmsa else 18
    want = {"k1_fwd": 0, "k1_fwd_tc": k1 * (steps + len(evals) * val_batches),
            "k1_bwd": 0, "k1_bwd_tc": k1 * steps,
            "k2": 18 * len(evals) * val_batches}
    models = os.path.join(log_dir, "models")
    best = os.path.join(models, "model_best.pth")
    print(f"{what} Uformer-32 b{TRAIN_BATCH}x{TRAIN_PS}² bf16 CR on: "
          f"{len(losses)} steps, losses {[round(x, 4) for x in losses]}, "
          f"{len(evals)} evals; launches {counts} (want {want}); "
          f"steady {epoch['img_per_s']:.2f} img/s, peak device memory "
          f"{epoch.get('peak_mem_gib', float('nan')):.2f} GiB; "
          f"subprocess {secs:.1f}s", flush=True)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{what}: a step's loss is missing or not finite")
    if counts != want:
        fail(f"{what}: kernel launches per step are not {k1} K1 forward "
             f"and {k1} K1 backward, all on the tensor cores (and 18 K2 "
             "per eval forward)")
    for f in (best, os.path.join(models, "epoch_model_1.pth")):
        if not os.path.exists(f):
            fail(f"{what} did not write {f}")
    # reload model_best.pth into a fresh model; eval as the trainer does
    payload = load_checkpoint(best)
    model = build_model_and_params(
        ModelConfig(attention="full" if wmsa else "probsparse"), best,
        torch.device("cuda"))
    val, nv = _val_batches(PairedFolder(os.path.join(tmp, "val")), TRAIN_PS,
                           TRAIN_BATCH, u8=True)
    ps = []
    with torch.no_grad():
        for c, n in val:
            c = torch.from_numpy(c).cuda().float() / 255.0
            n = torch.from_numpy(n).cuda().float() / 255.0
            y = model(n, generator=torch.Generator().manual_seed(0))
            ps.append(M.batch_psnr(torch.clamp(y, 0.0, 1.0), c))
    psnr = float(np.mean(torch.cat(ps)[:nv].cpu().numpy()))
    logged = payload["extra"]["psnr"]
    print(f"model_best.pth (epoch {payload['epoch']}, it "
          f"{payload['extra']['iter']}) reloaded: PSNR {psnr:.4f} vs logged "
          f"{logged:.4f} (|d| {abs(psnr - logged):.2e})", flush=True)
    if abs(psnr - logged) > RELOAD_TOL:
        fail(f"{what}: the reloaded model_best.pth does not give the "
             "logged PSNR")
    return counts, epoch, r.stderr


def phase_device_data(tmp: str, stream_epoch: dict):
    """The device-resident training set (`--device_data`): (a) the 256
    training pairs uploaded once; every batch of an epoch that
    `Trainer.train_step_data`'s gather (`data.augment.gather_crops`) cuts
    on the card equals the streaming pipeline's host batch bit for bit;
    (b) `cli.train --device_data` with the streaming run's arguments and
    `--vgg_weights` from `cli.convert_vgg` (a seeded random VGG19 in
    torchvision's key layout): its launch counts, losses and reload are
    held as the streaming run's; its img/s and peak memory beside them."""
    import numpy as np
    import torch

    from dehaze_tpu_torch.cli import convert_vgg
    from dehaze_tpu_torch.data.augment import (dihedral_index_maps,
                                               gather_crops)
    from dehaze_tpu_torch.data.pipeline import (PairedFolder,
                                                epoch_schedule_arrays,
                                                load_all_pairs,
                                                train_batches)
    from dehaze_tpu_torch.models.vgg import synthesize_torchvision_state_dict

    folder = PairedFolder(os.path.join(tmp, "train"))
    t0 = time.perf_counter()
    hc, hn = load_all_pairs(folder, u8=True, num_workers=8)
    load_s = time.perf_counter() - t0
    data_c, data_n = (torch.from_numpy(a).cuda() for a in (hc, hn))
    sched = epoch_schedule_arrays(len(folder), hc.shape[1:3], TRAIN_BATCH,
                                  TRAIN_PS, SEED, 1)
    maps = dihedral_index_maps(TRAIN_PS, "cuda")
    rows = [torch.from_numpy(b).cuda() for b in sched]
    host = list(train_batches(folder, batch_size=TRAIN_BATCH,
                              patch_size=TRAIN_PS, seed=SEED, epoch=1,
                              num_workers=8, u8=True))
    if len(host) != len(rows):
        fail(f"device data: {len(rows)} schedule batches against "
             f"{len(host)} streaming batches")
    bad = [i for i, (b, (c, n)) in enumerate(zip(rows, host))
           if not (np.array_equal(gather_crops(data_c, b, maps).cpu().numpy(),
                                  c)
                   and np.array_equal(
                       gather_crops(data_n, b, maps).cpu().numpy(), n))]
    gather_ms = cuda_ms(lambda: (gather_crops(data_c, rows[0], maps),
                                 gather_crops(data_n, rows[0], maps)), 20)
    print(f"device data: {tuple(data_c.shape)} ×2 uint8 on the card "
          f"({2 * data_c.numel() / 2**20:.1f} MiB, decoded in {load_s:.2f}s)"
          f"; {len(rows)} batches of an epoch gathered on the card, "
          f"{len(rows) - len(bad)} equal to the streaming batches bit for "
          f"bit; gather {gather_ms:.4f} ms per batch (clean and hazy)",
          flush=True)
    if bad:
        fail(f"device data: gathered batches {bad} differ from the "
             "streaming pipeline's")
    del data_c, data_n, rows

    pth = os.path.join(tmp, "vgg19_features.pth")
    npz = os.path.join(tmp, "vgg19.npz")
    torch.save(synthesize_torchvision_state_dict("vgg19", seed=SEED), pth)
    convert_vgg.main(["--pth", pth, "--out", npz])
    counts, epoch, err = _train_cli(
        tmp, "_devdata", ["--device_data", "--vgg_weights", npz])
    if "RANDOM VGG" in err:
        fail("cli.train --vgg_weights still trained on a random VGG19")
    print(f"cli.train --device_data: steady {epoch['img_per_s']:.2f} img/s, "
          f"peak device memory {epoch.get('peak_mem_gib', float('nan')):.2f}"
          f" GiB; streaming run: {stream_epoch['img_per_s']:.2f} img/s, "
          f"{stream_epoch.get('peak_mem_gib', float('nan')):.2f} GiB",
          flush=True)
    return counts


def phase_remat(tmp: str):
    """One full-width train step (Uformer-32, batch 32 × 128², bf16, CR on,
    drop_path 0.1, MixUp on) from the same state, batch and generator
    states: plain, with --remat, and plain again (the step's own
    run-to-run gap), deterministic algorithms on (then 5 timed steps
    without them, after one more warm-up). Every gradient leaf of
    the remat step against the plain one (REMAT_TOL), every generator's
    state after the step equal, K1's forward launches 36 against 18 and
    its backward's 18 in both; steady ms per step and peak memory side by
    side. Returns the remat step's launch counts."""
    import warnings

    import torch

    from dehaze_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                         TrainConfig)
    from dehaze_tpu_torch.data.pipeline import PairedFolder, train_batches
    from dehaze_tpu_torch.train.trainer import Trainer

    clean, hazy = next(iter(train_batches(
        PairedFolder(os.path.join(tmp, "train")), batch_size=TRAIN_BATCH,
        patch_size=TRAIN_PS, seed=SEED, epoch=1, num_workers=8, u8=True)))
    gens = ("sample_gen", "droppath_gen", "dropout_gen", "mixup_gen")
    runs, nondet = {}, set()
    for label, remat in (("plain", False), ("remat", True),
                         ("plain again", False)):
        cfg = Config(model=ModelConfig(img_size=TRAIN_PS, remat=remat),
                     data=DataConfig(batch_size=TRAIN_BATCH),
                     train=TrainConfig(seed=SEED))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = Trainer(cfg, steps_per_epoch=8, device="cuda")
            torch.cuda.synchronize()
            reset_counts()
            # the compared step with deterministic algorithms, the timed
            # ones as training runs them
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.backends.cudnn.deterministic = True
            try:
                m = tr.train_step(clean, hazy, use_mixup=True)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = False
            counts = read_counts()
            grads = {k: p.grad.detach().cpu() for k, p in
                     tr.model.named_parameters()}
            states = [getattr(tr, g).get_state() for g in gens]
            ms = peak = None
            if label != "plain again":
                tr.train_step(clean, hazy, use_mixup=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(REMAT_REPS):
                    tr.train_step(clean, hazy, use_mixup=True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / REMAT_REPS * 1e3
                peak = torch.cuda.max_memory_allocated() / 2**30
        # ops without a deterministic CUDA implementation warn
        nondet |= {str(w.message)[:60] for w in caught
                   if "deterministic" in str(w.message)}
        runs[label] = (float(m["loss"]), grads, states, counts, ms, peak)
        del tr, m
        torch.cuda.empty_cache()

    def gap(a, b):
        worst, n_diff, bad = 0.0, 0, []
        for k in a:
            d = (b[k] - a[k]).abs().max().item()
            worst = max(worst, d)
            n_diff += d > 0
            if float((b[k] - a[k]).norm()) > REMAT_TOL * float(a[k].norm()):
                bad.append(k)
        return worst, n_diff, bad

    (lp, gp, sp, cp, msp, pkp), (lr, gr, sr, cr, msr, pkr) = (
        runs["plain"], runs["remat"])
    worst, n_diff, bad = gap(gp, gr)
    worst2, n_diff2, _ = gap(gp, runs["plain again"][1])
    states_equal = all(torch.equal(a, b) for a, b in zip(sp, sr))
    print(f"remat train step Uformer-32 b{TRAIN_BATCH}x{TRAIN_PS}² bf16 CR "
          f"on, drop_path 0.1, MixUp: loss {lr:.7f} vs plain {lp:.7f}; "
          f"{len(gp)} gradient leaves, {n_diff} not bit-identical, max "
          f"|d| {worst:.3e} (plain against plain again: {n_diff2} leaves, "
          f"max |d| {worst2:.3e}); generator states equal: {states_equal}; "
          f"K1 fwd (tensor cores) {cr['k1_fwd_tc']} vs {cp['k1_fwd_tc']}, "
          f"K1 bwd {cr['k1_bwd_tc']} vs {cp['k1_bwd_tc']}; step "
          f"{msr:.2f} ms vs {msp:.2f} ms, peak device memory {pkr:.2f} GiB "
          f"vs {pkp:.2f} GiB; ops without a deterministic implementation: "
          f"{sorted(nondet) or 'none'}", flush=True)
    if not math.isfinite(lr) or bad:
        fail(f"remat: gradient leaves {bad[:4]} beyond {REMAT_TOL:g} of "
             "the plain step's")
    if not states_equal:
        fail("remat: the generators' states after the step differ from "
             "the plain step's")
    if (cr["k1_fwd_tc"], cr["k1_bwd_tc"], cp["k1_fwd_tc"],
            cp["k1_bwd_tc"]) != (36, 18, 18, 18) or cr["k1_fwd"] \
            or cr["k1_bwd"]:
        k1 = {k: v for k, v in cr.items() if k.startswith("k1")}
        fail(f"remat: K1 launches {k1}, not 36 forward and 18 backward on "
             "the tensor cores (the plain step: 18 and 18)")
    return cr


def phase_parity_gate(tmp: str, pth: str):
    """`python -m dehaze_tpu_torch.cli.parity_gate` on the seeded
    Uformer-32 `.pth` and the three 1200×1600 pairs of phase 9 (square
    canvas, bf16, sampling seeded 0 per frame): with --expected_psnr the
    in-process mean and --tol 1e-3 it must exit 0, with the expected value
    1 dB off it must exit 1; 18 K1 and 18 K2 launches per frame. Returns
    the launches of both runs."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.ops import metrics as M

    folder = os.path.join(tmp, "eval_long")
    model = build_model_and_params(ModelConfig(), pth, torch.device("cuda"))
    psnrs = []
    for clean, hazy, _ in val_images(PairedFolder(folder)):
        run = make_whole_image_fn(
            lambda x: model(x, generator=torch.Generator().manual_seed(0)),
            *hazy.shape[:2], 128, square=True, device="cuda")
        psnrs.append(float(M.psnr(run(hazy[None])[0],
                                  torch.from_numpy(clean).cuda())))
    mean = float(np.mean(psnrs))
    del model
    cases = ((mean, 0), (mean + 1.0, 1))
    done, secs = _counted_clis([
        ("parity_gate", ["--ref_ckpt", pth, "--input_dir", folder,
                         "--expected_psnr", repr(expected), "--tol", "1e-3"],
         f"expected {expected:.4f}") for expected, _ in cases])
    total = {}
    for (expected, want_rc), (out, stats) in zip(cases, done):
        n = len(re.findall(r"^\S+: PSNR \S+ SSIM \S+$", out, re.M))
        per_frame = float(re.search(r"frames: (\S+) s/frame",
                                    out).group(1))
        print(f"cli.parity_gate --expected_psnr {expected:.6f} --tol 1e-3 "
              f"(in-process mean {mean:.6f}): exit {stats['rc']} (want "
              f"{want_rc}); {n} frames, {per_frame:.4f} s/frame after the "
              f"first on the square canvas 1664², launches per frame K1 "
              f"tensor cores {stats['k1_fwd_tc'] / max(n, 1):g} CUDA cores "
              f"{stats['k1_fwd'] / max(n, 1):g} K2 "
              f"{stats['k2'] / max(n, 1):g}; run {stats['secs']:.1f}s "
              f"(both in one process {secs:.1f}s)", flush=True)
        if stats["rc"] != want_rc:
            fail(f"cli.parity_gate exited {stats['rc']}, not {want_rc}")
        if n != 3 or (stats["k1_fwd_tc"], stats["k1_fwd"], stats["k2"]) \
                != (18 * n, 0, 18 * n):
            fail("cli.parity_gate: not 3 frames of 18 K1 (tensor-core "
                 "forward) and 18 K2 launches")
        for key, v in stats.items():
            if key not in ("rc", "secs", "peak_gib"):
                total[key] = total.get(key, 0) + v
    return total


def phase_train_profile(tmp: str):
    """Device time of two steady full-width train steps by kernel group."""
    import warnings

    import torch

    from dehaze_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                         TrainConfig)
    from dehaze_tpu_torch.data.pipeline import PairedFolder, train_batches
    from dehaze_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(), data=DataConfig(batch_size=TRAIN_BATCH),
                 train=TrainConfig(seed=SEED))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = Trainer(cfg, steps_per_epoch=8, device="cuda")
    folder = PairedFolder(os.path.join(tmp, "train"))
    t0 = time.perf_counter()
    batches = list(train_batches(folder, batch_size=TRAIN_BATCH,
                                 patch_size=TRAIN_PS, seed=SEED, epoch=1,
                                 num_workers=8, u8=True))
    load_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    clean, hazy = batches[0]
    for _ in range(2):
        tr.train_step(clean, hazy, use_mixup=False)
    torch.cuda.synchronize()
    host = 0.0
    reset_counts()
    t0 = time.perf_counter()
    for clean, hazy in batches[:4]:
        h0 = time.perf_counter()
        tr.train_step(clean, hazy, use_mixup=False)
        host += time.perf_counter() - h0
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    counts = read_counts()
    if (counts["k1_bwd_tc"], counts["k1_bwd"], counts["k1_fwd_tc"],
            counts["k1_fwd"]) != (18 * 4, 0, 18 * 4, 0):
        fail(f"train steps: K1 launches {counts}, not 18 forward and 18 "
             "backward per step, all on the tensor cores")
    # calls that make the host wait for the card (a blocking copy, .item())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.train_step(clean, hazy, use_mixup=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # every warning but the mode's own notice that it is a prototype
    syncs = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno} "
             f"{str(w.message)[:40]}" for w in caught
             if "prototype" not in str(w.message)]
    print(f"train step b{TRAIN_BATCH}x{TRAIN_PS}² bf16 CR on, batches in "
          f"memory: {step_ms:.2f} ms/step ({TRAIN_BATCH / step_ms * 1e3:.1f} "
          f"img/s), {host / 4 * 1e3:.2f} ms of it for the host to queue the "
          f"step; host waits for the card in a step: {len(syncs)} "
          f"{sorted(set(syncs))[:5]}; data pipeline alone (8 threads, PNG "
          f"decode, crop, dihedral): {load_ms:.2f} ms/batch", flush=True)
    return _profile(f"train step b{TRAIN_BATCH}x{TRAIN_PS}² bf16 CR on",
                    lambda: tr.train_step(clean, hazy, use_mixup=False),
                    2, step_ms)


# 11d, the analysis stack: the landscape grid (n × n points, LS_BATCHES
# batches of TRAIN_BATCH × TRAIN_PS² each), the (0, 0) loss in f32 and in
# bf16 on the card against the CPU in the same precision (relative, f32:
# 9.31e-08 measured), the timed point ×
# batch, and the short training run whose epoch files the trajectory
# reads.
LS_N, LS_BATCHES = 3, 2
LANDSCAPE_TOL = 1e-4
# the point in bf16 on the card (the sweep's precision: tensor-core K1,
# bf16 K2) against the CPU's plain twins in bf16: the weights and the
# stage outputs round alike, so the two differ by rounding flips and
# accumulation order (8.24e-04 measured at batch 32), not by bf16's whole
# gap to f32 (1.18e-02 on the card, 1.10e-02 on the CPU). On a batch of
# LS_BF16_BATCH: bf16 on the CPU is slower than f32, and this batch ends
# with the phase's other groups.
LANDSCAPE_BF16_TOL = 1e-2
LS_BF16_BATCH = 8
LANDSCAPE_REPS = 5
TRAJ_PAIRS, TRAJ_BATCH, TRAJ_EPOCHS = 8, 8, 3
CPU_REFERENCE_THREADS = 4  # half the host's cores: the CLIs run beside it


def _landscape_setup(tmp: str, pth: str, extra, batch: int = TRAIN_BATCH):
    """(model, point_loss, shared) of cli.landscape's loss with `extra`
    flags, on the card or the CPU (--device in extra): `shared` holds the
    first batch of a sweep with --batch_size `batch`, its MixUp and its
    tables drawn as the sweep draws them (a generator seeded 1)."""
    import torch

    from dehaze_tpu_torch.cli import landscape as TCLI
    from dehaze_tpu_torch.cli.common import (build_model_and_params,
                                             config_from_args)
    from dehaze_tpu_torch.data.pipeline import PairedFolder, train_batches
    from dehaze_tpu_torch.utils.transfer import to_device

    args = TCLI.build_parser().parse_args(
        ["--weights", pth, "--train_dir", os.path.join(tmp, "train"),
         "--train_ps", str(TRAIN_PS), "--batch_size", str(batch)]
        + [str(a) for a in extra])
    cfg = config_from_args(args)
    device = torch.device(args.device)
    model = build_model_and_params(cfg.model, args.weights, device)
    prepare, point_loss = TCLI.make_landscape_loss(cfg, args, model, device)
    clean, hazy = next(iter(train_batches(
        PairedFolder(cfg.data.train_dir), batch_size=batch,
        patch_size=TRAIN_PS, seed=cfg.train.seed, epoch=0, u8=True)))
    with torch.no_grad():
        shared = prepare(to_device(torch.from_numpy(clean), device),
                         to_device(torch.from_numpy(hazy), device),
                         torch.Generator().manual_seed(1))
    return model, point_loss, shared


def _landscape_cpu_point(tmp: str, pth: str, dtype: str, batch: str) -> float:
    """The landscape's (0, 0) loss in `dtype` on the CPU (the plain twins),
    on the first batch of a sweep with --batch_size `batch`."""
    import torch

    from dehaze_tpu_torch.ops import landscape as LS

    model, point_loss, shared = _landscape_setup(
        tmp, pth, ["--dtype", dtype, "--device", "cpu"], int(batch))
    with torch.no_grad():
        return float(point_loss(LS.model_params(model), shared))


def landscape_cpu_reference(tmp: str, pth: str, dtype: str, batch: int):
    """11d's reference in `dtype` on a batch of `batch`, in a process of
    its own on CPU_REFERENCE_THREADS threads, beside the phase's CLIs:
    (`_landscape_cpu_point`, its seconds)."""
    code = ("import json, sys\n"
            "import chip_smoke as c\n"
            "print('RESULT ' + json.dumps(c._landscape_cpu_point(*sys.argv[1:]"
            ")))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, tmp, pth, dtype,
                        str(batch)],
                       capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": REPO,
                            "OMP_NUM_THREADS": str(CPU_REFERENCE_THREADS)})
    if r.returncode != 0:
        fail(f"the landscape's {dtype} CPU reference exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    return _result(r.stdout), time.perf_counter() - t0


def phase_analysis(tmp: str, pth: str):
    """11d. The analysis stack on the card, its CLIs in one subprocess
    (_counted_clis), on phase 11's training set and phase 7's seeded
    Uformer-32 .pth:
    (a) `cli.landscape`, Uformer-32 bf16 with the CR loss on the random
        VGG19, LS_N × LS_N points of LS_BATCHES batches of 32 × 128²,
        serially and with --points_per_batch 3: the two CSVs equal byte for
        byte; 18 K1 forward launches (tensor cores) and 18 K2 per point and
        batch, no twin call; the same grid on FFA-Net (3 × 19 blocks, width
        64, L1), with no kernel launch; `cli.landscape_pair` on the two
        CSVs (its JSON line);
    (b) `cli.train` (no CR) for TRAJ_EPOCHS epochs of TRAJ_BATCH × 128²
        on a TRAJ_PAIRS-pair set, `cli.archive_params` over its epoch
        files and `cli.trajectory` over the archive with --best
        model_best.pth;
    (c) `cli.params_flops` (Uformer-32 at 128²: 18 K1 and 18 K2 launches,
        a finite positive GFLOPs count; the count's value is held against
        a hand count in tests/test_torch_port_analysis.py),
        `cli.monitor --count 2` and `cli.generate_patches` on two pairs
        (each crop the source's at the draw's offsets);
    (d) `cli.landscape --points_per_batch 2 --data_axis 2` as two gloo
        ranks on the card: rank 0's CSV equals the serial one;
    (e) the (0, 0) loss of the sweep's first batch on the card against
        the CPU's (`landscape_cpu_reference`, in the same precision): in
        f32 (LANDSCAPE_TOL relative) and in the sweep's bf16 on a batch of
        LS_BF16_BATCH (LANDSCAPE_BF16_TOL), and one point × batch timed by
        CUDA events in bf16 for Uformer-32 and FFA-Net.
    The sweeps and the pair, the training tools and the rest, (d) and the
    CPU's two sides of (e) run at the same time, in five groups of processes
    (their seconds are not measurements); the card's side of (e) runs
    alone in this process, after them. The figures are drawn where
    matplotlib is installed (else only in the CPU tests, and a line says
    so)."""
    import glob
    import importlib.util
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.data.images import load_img
    from dehaze_tpu_torch.data.synth import write_dataset
    from dehaze_tpu_torch.ops import landscape as LS

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    has_psutil = importlib.util.find_spec("psutil") is not None
    print(f"this host: matplotlib "
          f"{'installed' if has_mpl else 'NOT installed'}, psutil "
          f"{'installed' if has_psutil else 'NOT installed'}", flush=True)
    if not has_mpl:
        print("no matplotlib here: the figures of cli.landscape, "
              "cli.landscape_pair and cli.trajectory are drawn only by the "
              "CPU tests (tests/test_torch_port_landscape.py, "
              "tests/test_torch_port_analysis.py); their sweeps, statistics "
              "and points run here", flush=True)

    def fig(name):
        return os.path.join(tmp, name) if has_mpl else ""

    def csv_of(name):
        return os.path.join(tmp, f"landscape_{name}.csv")

    grid = ["--train_dir", os.path.join(tmp, "train"), "--train_ps",
            TRAIN_PS, "--batch_size", TRAIN_BATCH, "--n", LS_N,
            "--max_batches", LS_BATCHES]
    uformer = ["--weights", pth] + grid
    traj_train = os.path.join(tmp, "traj_train")
    write_dataset(traj_train, TRAJ_PAIRS, TRAIN_PS, seed=7)
    patch_src = os.path.join(tmp, "patch_src")
    write_dataset(patch_src, 2, 256, seed=8)
    models = os.path.join(tmp, "traj_log", "uformer_traj", "models")
    archive = os.path.join(tmp, "traj_archive")
    runs = [
        ("landscape", uformer + ["--out_csv", csv_of("serial"),
                                 "--out_plot", fig("landscape.jpg")],
         "Uformer-32 serial"),
        ("landscape", uformer + ["--points_per_batch", 3, "--out_csv",
                                 csv_of("p3"), "--out_plot", ""],
         "Uformer-32 --points_per_batch 3"),
        ("landscape", ["--arch", "ffa", "--weights", _ffa_weights(tmp)]
         + grid + ["--out_csv", csv_of("ffa"), "--out_plot", ""], "FFA-Net"),
        ("landscape_pair", [csv_of("serial"), csv_of("ffa"), "--labels",
                            "Uformer-32", "FFA-Net", "--out",
                            fig("landscape_pair.jpg")], ""),
        ("train", ["--train_dir", traj_train, "--val_dir",
                   os.path.join(tmp, "val"), "--train_ps", TRAIN_PS,
                   "--batch_size", TRAJ_BATCH, "--nepoch", TRAJ_EPOCHS,
                   "--w_loss_vgg7", 0, "--save_dir",
                   os.path.join(tmp, "traj_log"), "--env", "_traj"],
         f"{TRAJ_EPOCHS} epochs"),
        ("archive_params", ["--models_dir", models, "--out_dir", archive],
         ""),
        ("trajectory", ["--ckpt_dir", archive, "--best",
                        os.path.join(models, "model_best.pth"), "--out",
                        fig("trajectory.png")], ""),
        ("params_flops", [], "Uformer-32 128²"),
        ("monitor", ["--count", 2, "--interval", 0], "--count 2"),
        ("generate_patches", ["--src_dir", patch_src, "--tar_dir",
                              os.path.join(tmp, "patches"), "--ps", 64,
                              "--num_patches", 4, "--num_cores", 2,
                              "--seed", 7], "2 pairs"),
    ]
    spec = json.dumps([["landscape", [str(a) for a in uformer + [
        "--points_per_batch", 2, "--data_axis", 2, "--device", "cuda:0",
        "--dist_backend", "gloo", "--out_csv", csv_of("data_axis"),
        "--out_plot", ""]]]])
    f32 = ["--dtype", "float32"]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(5) as ex:
        # the sweeps and the tools in two processes, the ranks and the CPU
        # references beside them
        groups = [ex.submit(_counted_clis, runs[:4]),
                  ex.submit(_counted_clis, runs[4:])]
        ranks = ex.submit(_ranks, ["-c", _RUNNER, spec], 2,
                          "cli.landscape --data_axis 2")
        cpu_reference = {
            dt: ex.submit(landscape_cpu_reference, tmp, pth, dt, batch)
            for dt, batch in (("float32", TRAIN_BATCH),
                              ("bfloat16", LS_BF16_BATCH))}
        (res_a, secs_a), (res_b, secs_b) = (g.result() for g in groups)
        outs = [_split_runs(o)[0] for o in ranks.result()]
        (host, cpu_secs), (host16, cpu16_secs) = (
            cpu_reference[dt].result() for dt in ("float32", "bfloat16"))
    together = time.perf_counter() - t0
    res, secs = res_a + res_b, (secs_a, secs_b)
    for (cli, _, label), (_, st) in zip(runs, res):
        if st["rc"]:
            fail(f"cli.{cli} {label} exited {st['rc']}")
    out = {name: r for name, r in zip(
        ("serial", "p3", "ffa", "pair", "train", "archive", "trajectory",
         "flops", "monitor", "patches"), res)}

    # (a) the sweeps
    points = LS_N * LS_N
    rows = {k: LS.load_landscape_csv(csv_of(k)) for k in
            ("serial", "p3", "ffa")}
    for k, r in rows.items():
        if len(r) != points or not all(
                math.isfinite(v) for row in r for v in row.values()):
            fail(f"the {k} landscape CSV is not {points} finite rows")
    with open(csv_of("serial")) as a, open(csv_of("p3")) as b:
        if a.read() != b.read():
            fail("cli.landscape --points_per_batch 3 did not write the "
                 "serial sweep's CSV")
    per = points * LS_BATCHES
    for k in ("serial", "p3"):
        _check_launches(f"cli.landscape {k}", out[k][1], per)
    _zero_launches("cli.landscape --arch ffa", out["ffa"][1])
    center = {k: next(r["loss"] for r in rows[k]
                      if r["x"] == 0.0 and r["y"] == 0.0)
              for k in ("serial", "ffa")}
    print(f"cli.landscape {LS_N}x{LS_N} x {LS_BATCHES} batches of "
          f"{TRAIN_BATCH}x{TRAIN_PS}² bf16: Uformer-32 (CR on) run "
          f"{out['serial'][1]['secs']:.1f}s, --points_per_batch 3 run "
          f"{out['p3'][1]['secs']:.1f}s (CSV byte for byte the serial "
          f"one), FFA-Net run {out['ffa'][1]['secs']:.1f}s; (0, 0) loss "
          f"Uformer-32 {center['serial']:.6f}, FFA-Net "
          f"{center['ffa']:.6f}; launches per point x batch: K1 "
          f"{out['serial'][1]['k1_fwd_tc'] / per:g}, K2 "
          f"{out['serial'][1]['k2'] / per:g}", flush=True)
    stats = json.loads(out["pair"][0].strip().splitlines()[-1])
    if set(stats) != {"Uformer-32", "FFA-Net", "flatter"}:
        fail(f"cli.landscape_pair printed {stats}")

    # (b) the training tools
    eps = sorted(os.listdir(models))
    want_eps = [f"epoch_model_{e}.pth" for e in range(1, TRAJ_EPOCHS + 1)]
    if [e for e in eps if e.startswith("epoch_model_")] != want_eps:
        fail(f"cli.train wrote {eps}, want {want_eps} and model_best.pth")
    if f"archived {TRAJ_EPOCHS} new ({TRAJ_EPOCHS} total)" not in \
            out["archive"][0]:
        fail(f"cli.archive_params: {out['archive'][0]!r}")
    for e in want_eps:
        if "optimizer" in torch.load(os.path.join(archive, e),
                                     weights_only=True):
            fail(f"the archived {e} holds the optimizer state")
    traj = [(float(t), float(r)) for t, r in re.findall(
        r"epoch_model_\d+\.pth: theta=(\S+) r=(\S+)", out["trajectory"][0])]
    if len(traj) != TRAJ_EPOCHS or not all(
            math.isfinite(v) for p in traj for v in p):
        fail(f"cli.trajectory printed {traj}")
    tr = out["train"][1]
    logs = glob.glob(os.path.join(tmp, "traj_log", "uformer_traj",
                                  "*.jsonl"))
    evals = sum(json.loads(ln)["kind"] == "eval" for f in logs
                for ln in open(f))
    steps = TRAJ_EPOCHS * (TRAJ_PAIRS // TRAJ_BATCH)
    fwd = steps + evals * -(-N_VAL // TRAJ_BATCH)
    want = (18 * fwd, 18 * steps, 18 * evals * -(-N_VAL // TRAJ_BATCH))
    if (tr["k1_fwd_tc"], tr["k1_bwd_tc"], tr["k2"]) != want or tr["k1_fwd"] \
            or tr["k1_bwd"]:
        fail(f"cli.train for the trajectory: launches {tr}, want (K1 fwd, "
             f"K1 bwd, K2) {want} on the tensor cores")
    print(f"cli.train {TRAJ_EPOCHS} epochs x {steps // TRAJ_EPOCHS} steps "
          f"({TRAJ_BATCH}x{TRAIN_PS}², {evals} evals) run {tr['secs']:.1f}s"
          f"; cli.archive_params run {out['archive'][1]['secs']:.1f}s; "
          f"cli.trajectory (theta, r) {[(round(t, 4), round(r, 4)) for t, r in traj]} "
          f"run {out['trajectory'][1]['secs']:.1f}s", flush=True)

    # (c) params_flops, monitor, generate_patches
    st = out["flops"][1]
    _check_launches("cli.params_flops", st, 1)
    gflops = float(re.search(r"GFLOPs .*: (\S+)", out["flops"][0]).group(1))
    if not (math.isfinite(gflops) and gflops > 0):
        fail(f"cli.params_flops counted {gflops} GFLOPs")
    lines = out["monitor"][0].strip().splitlines()
    if len(lines) != 2 or not all(re.fullmatch(
            r"\d\d:\d\d:\d\d cpu +\d+\.\d%  mem +\d+\.\d%", ln)
            for ln in lines):
        fail(f"cli.monitor printed {lines}")
    ptar = os.path.join(tmp, "patches")
    for i, pair in enumerate(zip(*(sorted(os.listdir(os.path.join(
            patch_src, sub))) for sub in ("gt", "hazy")))):
        rng = np.random.default_rng((7, i))
        for j in range(4):
            r0, c0 = (int(rng.integers(0, 256 - 64)) for _ in range(2))
            for sub, name in zip(("gt", "hazy"), pair):
                src = load_img(os.path.join(patch_src, sub, name), u8=True)
                got = load_img(os.path.join(ptar, sub, f"{i + 1}_{j + 1}.png"),
                               u8=True)
                if not np.array_equal(got, src[r0:r0 + 64, c0:c0 + 64]):
                    fail(f"cli.generate_patches: {sub}/{i + 1}_{j + 1}.png "
                         "is not the source's crop")
    print(f"cli.params_flops Uformer-32 128²: {gflops} GFLOPs, run "
          f"{st['secs']:.1f}s; cli.monitor "
          f"{lines}; cli.generate_patches 2 pairs x 4 patches run "
          f"{out['patches'][1]['secs']:.1f}s; the two CLI processes "
          f"{secs[0]:.1f}s and {secs[1]:.1f}s", flush=True)

    # (d) two gloo ranks, --data_axis 2
    if any(st["rc"] for _, st in outs):
        fail("cli.landscape --data_axis 2 failed on a rank")
    with open(csv_of("serial")) as a, open(csv_of("data_axis")) as b:
        if a.read() != b.read():
            fail("cli.landscape --data_axis 2 (two gloo ranks) did not "
                 "write the serial sweep's CSV")
    dp = {k: sum(st[k] for _, st in outs) for k in
          ("k1_fwd_tc", "k1_fwd", "k2", "twin_k1", "twin_k2")}
    chunks = -(-points // 2)
    _check_launches("cli.landscape --data_axis 2", dp, 2 * chunks * LS_BATCHES)
    print(f"cli.landscape --points_per_batch 2 --data_axis 2, two gloo ranks "
          f"on one card: CSV byte for byte the serial one; launches over "
          f"both ranks {dp} ({2 * chunks} points with the padded one); "
          f"rank runs {[round(st['secs'], 1) for _, st in outs]} s; "
          f"the five groups together {together:.1f}s", flush=True)

    # (e) the (0, 0) loss in f32, card against CPU; the timed point
    model, point_loss, shared = _landscape_setup(tmp, pth, f32)
    with torch.no_grad():
        card = float(point_loss(LS.model_params(model), shared))
    del model, shared
    rel = abs(card - host) / abs(host)
    print(f"landscape (0, 0) loss, first batch {TRAIN_BATCH}x{TRAIN_PS}², "
          f"f32, CR on: card {card:.7f}, CPU {host:.7f} (plain twins, "
          f"{cpu_secs:.1f}s): relative |d| {rel:.2e} (tolerance "
          f"{LANDSCAPE_TOL:g})", flush=True)
    if not rel <= LANDSCAPE_TOL:
        fail("the landscape's (0, 0) loss on the card is not the CPU's")
    ms = {}
    for name, extra in (("Uformer-32", []),
                        ("FFA-Net", ["--arch", "ffa"])):
        weights = _ffa_weights(tmp) if extra else pth
        model, point_loss, shared = _landscape_setup(tmp, weights, extra)
        params = LS.model_params(model)
        with torch.no_grad():
            ms[name] = cuda_ms(lambda: point_loss(params, shared),
                               LANDSCAPE_REPS)
        del model, shared, params
    # the sweep's own precision: the bf16 tensor-core K1 and the bf16 K2
    model, point_loss, shared = _landscape_setup(tmp, pth, [], LS_BF16_BATCH)
    with torch.no_grad():
        bf16 = float(point_loss(LS.model_params(model), shared))
    del model, shared
    rel16 = abs(bf16 - host16) / abs(host16)
    print(f"landscape (0, 0) loss, first batch of a --batch_size "
          f"{LS_BF16_BATCH} sweep ({TRAIN_PS}²), bf16 (the sweep's "
          f"kernels), CR on: card {bf16:.7f}, CPU bf16 {host16:.7f} (plain "
          f"twins, {cpu16_secs:.1f}s): relative |d| {rel16:.2e} (tolerance "
          f"{LANDSCAPE_BF16_TOL:g})", flush=True)
    if not rel16 <= LANDSCAPE_BF16_TOL:
        fail("the landscape's bf16 (0, 0) loss on the card is not the "
             "CPU's bf16 one")
    print(f"landscape point x batch ({TRAIN_BATCH}x{TRAIN_PS}², bf16, CUDA "
          f"events, {LANDSCAPE_REPS} reps): Uformer-32 "
          f"{ms['Uformer-32']:.2f} ms (forward + Charbonnier + CR on VGG19 "
          f"of the restored batch), FFA-Net {ms['FFA-Net']:.2f} ms "
          "(forward + L1)", flush=True)
    landscape = {k: out["serial"][1].get(k, 0) + out["p3"][1].get(k, 0)
                 + dp.get(k, 0) for k in _counters()}
    return {"landscape": landscape, "landscape_ffa": out["ffa"][1],
            "params_flops": out["flops"][1],
            "train_trajectory": out["train"][1]}


# The stages of Uformer-32 on the serving rect canvas 1280×1664: feature
# map H × W and heads; head dim 32 and 8×8 windows at each, the second
# block shifted except in the bottleneck (its configured resolution is the
# window's).
WMSA_STAGES = [("enc0", 1280, 1664, 1), ("enc1", 640, 832, 2),
               ("enc2", 320, 416, 4), ("enc3", 160, 208, 8),
               ("bottleneck", 80, 104, 16), ("dec0", 160, 208, 16),
               ("dec1", 320, 416, 8), ("dec2", 640, 832, 4),
               ("dec3", 1280, 1664, 2)]
# 13c: the W-MSA training run's data: the first 128 pairs of phase 11's
# set (4 steps).
WMSA_TRAIN_PAIRS = 128


def _wmsa_attention_ms():
    """CUDA-event ms of `ops.probsparse.full_window_attention` (plain
    torch, bf16, token-major) at each of the 18 attention calls of a
    serving frame: {stage: ms of its two blocks}."""
    import torch

    from dehaze_tpu_torch.ops import window as win_ops
    from dehaze_tpu_torch.ops.probsparse import full_window_attention

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, h, w, heads in WMSA_STAGES:
        nw = (h // 8) * (w // 8)
        q, k, v = (torch.randn((nw, 64, heads, 32), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = win_ops.gather_rel_pos_bias(
            torch.randn((15 * 15, heads), generator=g, device="cuda") * 0.02,
            8, 8)
        region = (None if name == "bottleneck" else torch.from_numpy(
            win_ops.shift_region_ids(h, w, 8, 4)).cuda())
        ms = 0.0
        for reg in (None, region):
            ms += cuda_ms(lambda: full_window_attention(
                q, k, v, rel_pos_bias=bias, sw_region=reg, layout="bnhd"), 5)
        out[name] = ms
        del q, k, v
    return out


def phase_wmsa(tmp: str):
    """13. The W-MSA Uformer-32 (`attention='full'`: plain torch attention,
    K2 for LeFF, no K1), seeded random weights:
    (a) f32 with TF32 off, CUDA (K2) against CPU (its twin), same weights:
        'linear'+'leff' at 256², 'conv'+'ffn'+`se_layer` and
        'linear_concat'+'leff' at 128², each within MODEL_TOL;
    (b) the 1200×1600 frame, bf16, rect canvas, through the whole-image
        function: s/frame, Mpix/s, peak memory; 18 K2 and 0 K1 launches per
        frame and no twin call; the attention alone at the frame's 18 shapes
        (CUDA events) and a profile of one frame;
    (c) `cli.train --attention full` at batch 32 × 128², CR on, on 128 of
        phase 11's pairs (4 steps, 4 evals): finite losses, img/s, no K1;
    (d) `cli.export --square` in process: the artifact bit for bit the
        eager forward, both timed in turns; `cli.parity_gate --attention
        full` on phase 9's three pairs at the in-process mean PSNR (--tol
        1e-3, exit 0; per-image PSNRs as the in-process function's) and
        `cli.test_long --exported` (its PSNRs as the gate's, which are
        --weights').
    Returns the launches of each path: serve_wmsa, eval_wmsa (the gate),
    eval_exported_wmsa, train_wmsa."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli import export as cli_export
    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.pipeline import PairedFolder, val_images
    from dehaze_tpu_torch.infer.export import load_exported
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.models.uformer import Uformer
    from dehaze_tpu_torch.ops import metrics as M

    # (a) CUDA against CPU, f32
    for flags, size in (({}, 256),
                        (dict(token_projection="conv", token_mlp="ffn",
                              se_layer=True), 128),
                        (dict(token_projection="linear_concat"), 128)):
        torch.manual_seed(SEED)
        cfg = ModelConfig(attention="full", dtype=torch.float32, **flags)
        cpu = Uformer(cfg).eval()
        gpu = Uformer(cfg, device="cuda").eval()
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.default_rng(SEED).uniform(
            size=(1, size, size, 3)).astype(np.float32))
        reset_counts()
        with torch.inference_mode():
            want = cpu(x)
            got = gpu(x.cuda()).cpu()
        k2 = read_counts()["k2"]
        d = (got - want).abs()
        label = "+".join([flags.get("token_projection", "linear"),
                          flags.get("token_mlp", "leff")]
                         + (["se_layer"] if flags.get("se_layer") else []))
        print(f"W-MSA {label} {size}² f32 CUDA vs CPU: max|d|="
              f"{float(d.max()):.3e} mean|d|={float(d.mean()):.3e}; K2 "
              f"launches {k2}", flush=True)
        if not torch.isfinite(got).all() or float(d.max()) > MODEL_TOL:
            fail(f"W-MSA {label}: CUDA vs CPU beyond {MODEL_TOL:g}")
        if k2 != (0 if flags.get("token_mlp") == "ffn" else 18):
            fail(f"W-MSA {label}: {k2} K2 launches on the card")
        if label == "linear+leff":
            pth = os.path.join(tmp, "uformer32_wmsa_seed.pth")
            torch.save({"state_dict": cpu.state_dict()}, pth)
        del cpu, gpu

    # (b) the serving frame, bf16
    model = build_model_and_params(ModelConfig(attention="full"), pth,
                                   torch.device("cuda"))
    run = make_whole_image_fn(model, *FRAME, 128, square=False,
                              device="cuda")
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)
    run(frame)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reps = 3
    with _TwinCounts() as twins:
        t0 = time.perf_counter()
        for _ in range(reps):
            y = run(frame)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / reps
    serve = {**read_counts(), **twins}
    peak = torch.cuda.max_memory_allocated() / 2**30
    attn = _wmsa_attention_ms()
    total = sum(attn.values())
    mpix = FRAME[0] * FRAME[1] / 1e6
    print(f"W-MSA whole image {FRAME[0]}x{FRAME[1]} rect canvas 1280x1664 "
          f"bf16: {secs:.4f} s/frame {mpix / secs:.3f} Mpix/s peak mem "
          f"{peak:.2f} GiB; launches over {reps} frames K1 (tensor cores) "
          f"{serve['k1_fwd_tc']} (CUDA cores) {serve['k1_fwd']} K2 "
          f"{serve['k2']}, twin calls K1 {twins['twin_k1']} K2 "
          f"{twins['twin_k2']}; range [{float(y.min()):.4f}, "
          f"{float(y.max()):.4f}]", flush=True)
    print(f"W-MSA attention alone at the frame's 18 calls (bf16, CUDA "
          f"events): {total:.3f} ms, {total / (secs * 1e3):.1%} of the "
          "frame; by stage (two blocks each): " + ", ".join(
              f"{k} {v:.3f}" for k, v in attn.items()), flush=True)
    if tuple(y.shape) != (1,) + FRAME + (3,) \
            or not bool(torch.isfinite(y).all()):
        fail("W-MSA whole-image output has the wrong shape or non-finite "
             "values")
    _check_launches("W-MSA whole-image forward", serve, reps, k1=0)
    _profile(f"one W-MSA {FRAME[0]}x{FRAME[1]} serving frame on the rect "
             "canvas, bf16", lambda: run(frame), 1, secs * 1e3)

    # (d) the gate, the artifact and test_long --exported on phase 9's pairs
    folder = os.path.join(tmp, "eval_long")
    psnrs = []
    for clean, hazy, _ in val_images(PairedFolder(folder)):
        sq = make_whole_image_fn(model, *hazy.shape[:2], 128, square=True,
                                 device="cuda")
        psnrs.append(float(M.psnr(sq(hazy[None])[0],
                                  torch.from_numpy(clean).cuda())))
    mean = float(np.mean(psnrs))
    art = os.path.join(tmp, "wmsa_square.dhz")
    info = cli_export.main(["--weights", pth, "--attention", "full",
                            "--square", "--out", art])
    fn, _ = load_exported(art, "cuda")
    eager = make_whole_image_fn(model, *FRAME, 128, square=True,
                                device="cuda")
    x = torch.from_numpy(frame.astype(np.float32) / 255.0).cuda()
    same = torch.equal(fn(x), eager(x))
    times = [cuda_ms(lambda: fn(x), 5), cuda_ms(lambda: eager(x), 5),
             cuda_ms(lambda: eager(x), 5), cuda_ms(lambda: fn(x), 5)]
    print(f"W-MSA artifact (square canvas 1664², {info['mb']:.1f} MB, "
          f"export {info['export_s']:.1f}s) against the eager forward: "
          f"equal {same}; ms/frame artifact, eager, eager, artifact: "
          f"{', '.join(f'{t:.2f}' for t in times)}", flush=True)
    if not same:
        fail("the W-MSA artifact differs from the eager CUDA forward")
    del model, run, fn, eager
    ((out, gate), (out_x, exported)), secs = _counted_clis([
        ("parity_gate", ["--ref_ckpt", pth, "--input_dir", folder,
                         "--attention", "full", "--expected_psnr",
                         repr(mean), "--tol", "1e-3"], "--attention full"),
        ("test_long", ["--input_dir", folder, "--exported", art,
                       "--no-save_images"], "--exported (W-MSA)")])
    gate_psnrs = [float(p) for p in re.findall(r"^\S+: PSNR (\S+) SSIM",
                                               out, re.M)]
    worst = max((abs(a - b) for a, b in zip(gate_psnrs, psnrs)),
                default=math.inf)
    per_frame = float(re.search(r"frames: (\S+) s/frame", out).group(1))
    print(f"cli.parity_gate --attention full (in-process mean {mean:.6f}, "
          f"--tol 1e-3): {'PARITY OK' in out}; {len(gate_psnrs)} frames, "
          f"{per_frame:.4f} s/frame after the first on the square canvas "
          f"1664²; per-image PSNR vs the in-process function max |d| "
          f"{worst:.2e} dB; run {gate['secs']:.1f}s (with test_long "
          f"--exported, one process {secs:.1f}s)", flush=True)
    if gate["rc"] != 0 or "PARITY OK" not in out or len(gate_psnrs) != 3 \
            or worst > EVAL_PSNR_TOL:
        fail("cli.parity_gate --attention full: no PARITY OK at the "
             "in-process PSNR")
    _check_launches("cli.parity_gate --attention full", gate, 3, k1=0)
    got = [float(p) for p in re.findall(r"^\S+: PSNR (\S+) SSIM", out_x,
                                        re.M)]
    per_frame = float(re.search(r"frames: (\S+) s/frame", out_x).group(1))
    print(f"cli.test_long --exported (W-MSA square artifact): "
          f"{per_frame:.4f} s/frame after the first; PSNRs {got} against "
          f"--weights' {gate_psnrs}; run {exported['secs']:.1f}s",
          flush=True)
    worst = max((abs(a - b) for a, b in zip(got, gate_psnrs)),
                default=math.inf)
    if exported["rc"] != 0 or len(got) != 3 or worst > EVAL_PSNR_TOL:
        fail("cli.test_long --exported (W-MSA): PSNRs differ from "
             "--weights")
    _check_launches("cli.test_long --exported (W-MSA)", exported, 3, k1=0)

    # (c) training, on a 128-pair subset of phase 11's set
    sub = os.path.join(tmp, "train_wmsa")
    for part in ("gt", "hazy"):
        os.makedirs(os.path.join(sub, part))
        for name in sorted(os.listdir(os.path.join(tmp, "train", part))
                           )[:WMSA_TRAIN_PAIRS]:
            os.symlink(os.path.join(tmp, "train", part, name),
                       os.path.join(sub, part, name))
    train, _, _ = _train_cli(tmp, "_wmsa", ["--attention", "full"],
                             wmsa=True, train_dir=sub)
    return {"serve_wmsa": serve, "eval_wmsa": gate,
            "eval_exported_wmsa": exported, "train_wmsa": train}


# 14. The multi-GPU paths on the one card: two ranks that share it over
# gloo (NCCL refuses two ranks on one device: scripts/dist_probe.py) and
# one NCCL rank. Nothing here measures multi-GPU speed.
# The banded frame against the one-process frame (max |d|, mean |d|) on
# the [0, 1] image. f32 (TF32 off): the same ops but K2 against the
# unfused LeFF, sum order only: MODEL_TOL. bf16: K2 and the unfused LeFF
# (cuBLAS, cuDNN, GELU in bf16) round at other points, each LeFF within
# K2_TOL of the other, and 18 blocks carry the difference along the
# residual stream: 1/16 at a pixel and 2e-3 on average.
BAND_TOL = {"float32": (MODEL_TOL, MODEL_TOL), "bfloat16": (0.0625, 2e-3)}
# cli.test_long --bands 2 (bf16) against the one-process PSNRs, dB: a mean
# |d| of 2e-3 on an image ~0.1 from its ground truth moves the MSE by up to
# 0.4%, 0.02 dB.
BAND_PSNR_TOL = 0.05
# FFA-Net's banded native frame against the one-process frame (max |d|,
# mean |d|) on the clamped [0, 1] image: the bands run the same convs on
# 601-row slabs (cuDNN may sum in another order) and average the pooled
# means over the ranks, rounded to bf16 at another point than one process
# rounds them. Read on the H100: f32 (TF32 off) 1.371e-6 / 2.420e-8, bf16
# 1.270e-2 / 2.830e-4; the limits leave 2-7x, where a seam fault moves
# the rows next to the seam by tenths (zeros for the halo above the second
# band: max |d| 0.63 on a 48×64 frame, in f32 and in bf16).
FFA_BAND_TOL = {"float32": (1e-5, 1e-7), "bfloat16": (0.03, 1e-3)}
# The DDP steps of two ranks (16 rows each) against one rank's (32 rows):
# the same data, weights and draws; the step losses relative. bf16 GEMMs
# and convs at another batch may pick other kernels and round differently
# (first step 2e-3); AdamW's first steps move a weight by about ±lr
# whatever its gradient's size, so such rounding moves weights from the
# second step on (2e-2).
DDP_TOL = (2e-3, 2e-2)
DDP_STEPS, DDP_REPS = 4, 3  # steps of 32 rows; timed frames and turns

# A rank of phase 14 (argv: mode, tmp, pth). "gloo2": the banded frame
# (bf16 timed and counted, f32 once), FFA-Net's native frame in the same
# two bands (phase 15's seeded .pk, bf16 and f32, counted) and DDP steps
# at 16 rows; "nccl1":
# DDP steps at 32 rows, the reference, and the plain step against the DDP
# step in turns. Prints one RESULT line of JSON.
_MULTI_WORKER = r'''
import json, os, sys, time
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dehaze_tpu_torch.cli.common import build_model_and_params
from dehaze_tpu_torch.config import (Config, DataConfig, LossConfig,
                                     ModelConfig, TrainConfig)
from dehaze_tpu_torch.infer.halo_sharded import (
    make_halo_sharded_frame_fn, make_halo_sharded_native_fn)
from dehaze_tpu_torch.infer.tiled import normalize_hazy
from dehaze_tpu_torch.ops import probsparse as ps
from dehaze_tpu_torch.ops.kernels import leff, window_attention as wa
from dehaze_tpu_torch.parallel import dist
from dehaze_tpu_torch.train.trainer import Trainer

mode, tmp, pth = sys.argv[1:4]
seed, (H, W), steps, reps = json.loads(sys.argv[4])
dev = dist.init("cuda:0", "gloo" if mode == "gloo2" else "nccl")
r, n = dist.rank(), dist.world()
twins = {"twin_k1": 0, "twin_k2": 0}
def counted(fn, key):
    def call(*a, **kw):
        twins[key] += 1
        return fn(*a, **kw)
    return call
ps.probsparse_attention_bnc = counted(ps.probsparse_attention_bnc, "twin_k1")
leff.leff_reference = counted(leff.leff_reference, "twin_k2")
COUNTERS = {"k1_fwd_tc": (wa.window_attention_fwd, "launches_tc"),
            "k1_fwd": (wa.window_attention_fwd, "launches"),
            "k1_bwd_tc": (wa.window_attention_bwd, "launches_tc"),
            "k1_bwd": (wa.window_attention_bwd, "launches"),
            "k2": (leff.leff_fused, "launches")}
def reset():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    for k in twins:
        twins[k] = 0
def counts():
    return {**{k: getattr(fn, a) for k, (fn, a) in COUNTERS.items()},
            **twins}
def sync_ms(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3
res = {"rank": r}
if mode == "gloo2":
    frame = np.random.default_rng(seed).integers(
        0, 256, size=(1, H, W, 3), dtype=np.uint8)
    model = build_model_and_params(ModelConfig(), pth, dev)
    run = make_halo_sharded_frame_fn(model, H, W, 128, seed=seed, device=dev)
    run(frame)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = run(frame)
    res["band_s"] = sync_ms(t0) / 1e3 / reps
    res["band_counts"] = counts()
    res["band_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    model32 = build_model_and_params(ModelConfig(dtype=torch.float32), pth,
                                     dev)
    y32 = make_halo_sharded_frame_fn(model32, H, W, 128, seed=seed,
                                     device=dev)(frame)
    if r == 0:
        np.savez(os.path.join(tmp, "banded.npz"), bf16=y.cpu().numpy(),
                 f32=y32.cpu().numpy())
    del model, model32
    # FFA-Net's native frame, normalized as the protocol does
    x = normalize_hazy(torch.from_numpy(frame).to(dev).float() / 255.0)
    reset()
    ffa = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = build_model_and_params(
            ModelConfig(arch="ffa", dtype=dt),
            os.path.join(tmp, "ffa_seed.pk"), dev)
        ffa[name] = make_halo_sharded_native_fn(model, device=dev)(
            x).cpu().numpy()
        del model
    res["ffa_band_counts"] = counts()
    if r == 0:
        np.savez(os.path.join(tmp, "banded_ffa.npz"), **ffa)
rng = np.random.default_rng(seed)
clean = rng.integers(0, 256, size=(steps, 32, 128, 128, 3), dtype=np.uint8)
hazy = np.clip(clean * 0.6 + 60, 0, 255).astype(np.uint8)
b = 32 // n
cfg = Config(data=DataConfig(batch_size=32), train=TrainConfig(warmup=False),
             loss=LossConfig(w_contrast=1.0))
tr = Trainer(cfg, steps_per_epoch=steps, device=dev, data_parallel=True)
sl = slice(r * b, (r + 1) * b)
losses, step_ms = [], []
torch.cuda.reset_peak_memory_stats()
reset()
for s in range(steps):
    t0 = time.perf_counter()
    m = tr.train_step(clean[s][sl], hazy[s][sl], use_mixup=s % 2 == 1)
    losses.append(float(m["loss"]))
    step_ms.append(sync_ms(t0))
res.update(losses=losses, step_ms=step_ms, train_counts=counts(),
           train_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
# the gradient all-reduce alone: DDP's bytes (every parameter, f32)
flat = torch.cat([p.detach().reshape(-1) for p in tr.model.parameters()])
res["grad_bytes"] = flat.numel() * 4
for _ in range(2):
    dist.barrier()
    t0 = time.perf_counter()
    torch.distributed.all_reduce(flat)
    res["allreduce_ms"] = sync_ms(t0)
if mode == "nccl1":  # DDP's own cost on one card: plain, DDP, DDP, plain
    plain = Trainer(cfg, steps_per_epoch=steps, device=dev)
    times = {"plain": [], "ddp": []}
    for arm in ("plain", "ddp", "ddp", "plain") * reps:
        t_ = plain if arm == "plain" else tr
        t0 = time.perf_counter()
        t_.train_step(clean[0], hazy[0], use_mixup=False)
        times[arm].append(sync_ms(t0))
    res["plain_ms"], res["ddp_ms"] = times["plain"], times["ddp"]
print("RESULT " + json.dumps(res), flush=True)
dist.shutdown()
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(argv, n: int, label: str, timeout: int = 600):
    """n processes of `python argv...` as the ranks of one process group,
    all on the one card (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT as torchrun sets them); each in its own session, killed
    with its children if the group outlives `timeout`. Returns each
    rank's stdout; fails if a rank fails."""
    import signal

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable] + [str(a) for a in argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env={**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "RANK": str(r),
             "WORLD_SIZE": str(n), "LOCAL_RANK": str(r)})
        for r in range(n)]
    outs, errs = [], []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
            errs.append(err)
    except subprocess.TimeoutExpired:
        fail(f"{label}: the ranks did not end within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"{label}: rank {r} exited {p.returncode}: "
                 f"{errs[r][-3000:]}")
    return outs


def _result(out: str) -> dict:
    return json.loads(out.split("RESULT ")[-1].splitlines()[0])


def phase_multi(tmp: str, pth: str, eval_psnrs):
    """14. The multi-GPU paths, with the seeded Uformer-32 (bf16):
    (a) two gloo ranks on the card: the 1200×1600 frame on the rect canvas
        1280×1664 in 2 bands (`infer.halo_sharded`) against the
        one-process frame, bf16 and f32 (BAND_TOL); 18 K1 forward launches
        per band and frame, 0 K2, 0 twin calls; s/frame and peak memory per
        rank; then DDP_STEPS DDP steps at 2 × 16 × 128², CR on, MixUp on
        every other step: finite, 18 K1 forward and 18 backward launches
        per rank and step, step ms, and the gradient all-reduce's ms;
    (b) one NCCL rank: the same steps at 32 rows, the reference of (a)
        (DDP_TOL), and the plain step against the DDP step in turns;
    (c) `cli.test_long --data_axis 2` (two gloo ranks) on the three
        evaluation pairs: the one-process PSNRs (phase 9), 18 K1 and 18 K2
        launches per frame over the ranks; then `--rect_canvas --bands 2`:
        the one-process rect-canvas PSNRs within BAND_PSNR_TOL, 18 K1
        launches per band and frame, no K2;
    (d) `cli.train --data_axis 1` as one NCCL rank (phase 11's run).
    The gloo ranks of (a) also run FFA-Net's native 1200×1600 frame in the
    same two bands (halo convs, rank-averaged pools; phase 15's seeded
    .pk), bf16 and f32, against the one-process native frame
    (FFA_BAND_TOL), with no kernel of the port and no twin.
    Two ranks that share one card measure no multi-GPU speed."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn

    spec = json.dumps([SEED, list(FRAME), DDP_STEPS, DDP_REPS])
    t0 = time.perf_counter()
    gloo = [_result(o) for o in _ranks(
        ["-c", _MULTI_WORKER, "gloo2", tmp, pth, spec], 2,
        "two gloo ranks")]
    secs = time.perf_counter() - t0
    got = np.load(os.path.join(tmp, "banded.npz"))
    frame = np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        model = build_model_and_params(ModelConfig(dtype=dtype), pth,
                                       torch.device("cuda"))
        ref = make_whole_image_fn(
            lambda c: model(c, generator=torch.Generator().manual_seed(SEED)),
            FRAME[0], FRAME[1], ps=128, square=False, device="cuda")(
                frame).cpu().numpy()
        del model
        d = np.abs(got["bf16" if dname == "bfloat16" else "f32"] - ref)
        tol = BAND_TOL[dname]
        print(f"banded frame, 2 gloo ranks, {dname}: max|d| "
              f"{float(d.max()):.3e} mean|d| {float(d.mean()):.3e} against "
              f"the one-process frame (tolerance {tol})", flush=True)
        if not np.isfinite(got["f32"]).all() or d.max() > tol[0] \
                or d.mean() > tol[1]:
            fail(f"the banded {dname} frame is not the one-process frame")
    band = {k: sum(g["band_counts"][k] for g in gloo)
            for k in gloo[0]["band_counts"]}
    want = {"k1_fwd_tc": 18 * 2 * DDP_REPS, "k1_fwd": 0, "k1_bwd_tc": 0,
            "k1_bwd": 0, "k2": 0, "twin_k1": 0, "twin_k2": 0}
    print(f"banded frame {FRAME[0]}x{FRAME[1]} rect canvas 1280x1664 bf16, "
          f"2 bands on one card: " + ", ".join(
              f"rank {g['rank']} {g['band_s']:.4f} s/frame peak "
              f"{g['band_peak_gib']:.2f} GiB" for g in gloo)
          + f"; launches over {DDP_REPS} frames {band} (want {want}); both "
          f"ranks' process {secs:.1f}s", flush=True)
    if band != want:
        fail("the banded frame did not launch K1's tensor-core forward 18 "
             "times per band and frame, and no K2 and no twin")
    # FFA-Net's native frame in the same two bands
    got = np.load(os.path.join(tmp, "banded_ffa.npz"))
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        model, run = _ffa_native(_ffa_weights(tmp), dtype)
        ref = run(frame).cpu().numpy()
        del model, run
        y = got["bf16" if dname == "bfloat16" else "f32"]
        d = np.abs(y - ref)
        tol = FFA_BAND_TOL[dname]
        print(f"FFA-Net banded native frame {FRAME[0]}x{FRAME[1]}, 2 gloo "
              f"ranks, {dname}: max|d| {float(d.max()):.3e} mean|d| "
              f"{float(d.mean()):.3e} against the one-process frame "
              f"(tolerance {tol})", flush=True)
        if y.shape != ref.shape or not np.isfinite(y).all() \
                or d.max() > tol[0] or d.mean() > tol[1]:
            fail(f"the banded FFA-Net {dname} frame is not the one-process "
                 "frame")
    ffa_band = {k: sum(g["ffa_band_counts"][k] for g in gloo)
                for k in gloo[0]["ffa_band_counts"]}
    _zero_launches("the banded FFA-Net frame", ffa_band)

    t0 = time.perf_counter()
    nccl = _result(_ranks(["-c", _MULTI_WORKER, "nccl1", tmp, pth, spec], 1,
                          "one NCCL rank")[0])
    secs = time.perf_counter() - t0
    for g in gloo + [nccl]:
        if not all(math.isfinite(x) for x in g["losses"]):
            fail("a DDP step's loss is not finite")
    rel = [abs(a - b) / abs(b) for a, b in zip(gloo[0]["losses"],
                                                nccl["losses"])]
    print(f"DDP {DDP_STEPS} steps Uformer-32 bf16 CR on: 2 gloo ranks x "
          f"16 rows losses {[round(x, 5) for x in gloo[0]['losses']]}"
          f", 1 NCCL rank x 32 rows {[round(x, 5) for x in nccl['losses']]}"
          f"; relative |d| {[f'{x:.2e}' for x in rel]} (tolerance "
          f"{DDP_TOL})", flush=True)
    if rel[0] > DDP_TOL[0] or max(rel[1:]) > DDP_TOL[1]:
        fail("the two-rank DDP steps are not the one-rank steps")
    want = {"k1_fwd_tc": 18 * DDP_STEPS, "k1_fwd": 0,
            "k1_bwd_tc": 18 * DDP_STEPS, "k1_bwd": 0, "k2": 0,
            "twin_k1": 0, "twin_k2": 0}
    for g in gloo + [nccl]:
        if g["train_counts"] != want:
            fail(f"DDP rank {g['rank']}: launches {g['train_counts']}, "
                 f"want {want} over {DDP_STEPS} steps")
        print(f"  rank {g['rank']} of {2 if g is not nccl else 1} "
              f"({'gloo' if g is not nccl else 'nccl'}): step ms "
              f"{[round(x, 1) for x in g['step_ms']]}, gradient all-reduce "
              f"{g['grad_bytes'] / 1e6:.1f} MB alone "
              f"{g['allreduce_ms']:.2f} ms, peak {g['train_peak_gib']:.2f} "
              "GiB", flush=True)
    print(f"one NCCL rank, batch 32 x 128² CR on, in turns: plain step "
          f"{[round(x, 2) for x in nccl['plain_ms']]} ms, DDP step "
          f"{[round(x, 2) for x in nccl['ddp_ms']]} ms (process "
          f"{secs:.1f}s)", flush=True)

    # (c) frame-parallel, then banded evaluation through the CLI, two gloo
    # ranks that run both (_RUNNER keeps their process group)
    long_dir, runs = os.path.join(tmp, "eval_long"), {}
    cases = ((["--data_axis", 2], "square"),
             (["--rect_canvas", "--bands", 2], "rect"))
    spec = json.dumps([["test_long", [str(a) for a in [
        "--input_dir", long_dir, "--weights", pth, "--seed", SEED,
        "--result_dir", os.path.join(tmp, "res_dp"), "--device", "cuda:0",
        "--dist_backend", "gloo"] + flags]] for flags, _ in cases])
    t0 = time.perf_counter()
    outs = [_split_runs(o) for o in _ranks(["-c", _RUNNER, spec], 2,
                                           "cli.test_long over two ranks")]
    secs = time.perf_counter() - t0
    for j, (flags, one) in enumerate(cases):
        what = "cli.test_long " + " ".join(str(f) for f in flags)
        out = outs[0][j][0]
        for ln in out.splitlines():
            print(f"  {what} | {ln}", flush=True)
        stats = [o[j][1] for o in outs]
        runs[one] = {k: sum(st[k] for st in stats)
                     for k in ("k1_fwd", "k1_fwd_tc", "k2", "twin_k1",
                               "twin_k2")}
        psnrs = [float(p) for p in re.findall(r"^\S+: PSNR (\S+) SSIM",
                                              out, re.M)]
        worst = max(abs(a - b) for a, b in zip(psnrs, eval_psnrs[one]))
        tol = EVAL_PSNR_TOL if one == "square" else BAND_PSNR_TOL
        print(f"{what} (2 gloo ranks, {one} canvas): PSNRs {psnrs} against "
              f"one process {eval_psnrs[one]}: max |d| {worst:.2e} dB "
              f"(tolerance {tol:g}); launches {runs[one]}; peak per rank "
              f"{[round(st['peak_gib'], 2) for st in stats]} GiB; run "
              f"{stats[0]['secs']:.1f}s (both runs {secs:.1f}s)",
              flush=True)
        if any(st["rc"] for st in stats) or len(psnrs) != 3 or worst > tol:
            fail(f"{what} does not give the one-process PSNRs")
    _check_launches("cli.test_long --data_axis 2", runs["square"], 3)
    _check_launches("cli.test_long --bands 2", runs["rect"], 3, k1=36, k2=0)

    # (d) one NCCL rank through cli.train --data_axis 1
    train1, _, _ = _train_cli(tmp, "_nccl1", ["--data_axis", "1"],
                              rank_env=True)
    return {"bands_frame": band, "bands_frame_ffa": ffa_band,
            "eval_data_axis": runs["square"],
            "eval_bands": runs["rect"],
            "train_ddp_gloo": {k: sum(g["train_counts"][k] for g in gloo)
                               for k in want},
            "train_ddp_nccl": nccl["train_counts"],
            "train_nccl_cli": train1}


_LAYOUT = "layout copies (NCHW<->NHWC)"
_GROUPS = [("K1 bwd (tensor cores)", ("window_attention_tc_bwd",
                                       "dbias_reduce")),
           ("K1 bwd (CUDA cores)", ("window_attention_bwd",)),
           ("K1 fwd (tensor cores)", ("window_attention_tc",)),
           ("K1 fwd (CUDA cores)", ("window_attention_fwd",)),
           ("K2", ("leff_fwd",)),
           # cuDNN's implicit-GEMM convolutions name themselves fprop/
           # dgrad/wgrad ..._implicit_gemm: conv before GEMM
           ("conv (cuDNN)", ("conv", "implicit", "wgrad", "dgrad",
                             "fprop")),
           (_LAYOUT, ("nchwtonhwc", "nhwctonchw")),
           ("GEMM (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas")),
           ("optimizer", ("adam", "multi_tensor", "foreach")),
           ("softmax/LN/reductions", ("softmax", "layer_norm", "reduce"))]


def _profile(what: str, step, steps: int, step_ms: float):
    """torch.profiler over `steps` calls of step(): device time by kernel
    group and the top kernels, the idle share against the profiled wall
    and against `step_ms` (the unprofiled ms per call). Returns (wall ms,
    device ms, {group: ms}) per call, or None without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    ms, by_kernel = {}, {}
    for evt in prof.key_averages():
        # user annotations (e.g. the optimizer's step range) span kernels
        # that are counted on their own
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        t = getattr(evt, "self_device_time_total", 0.0) / 1e3 / steps
        name = evt.key.lower()
        g = next((gname for gname, keys in _GROUPS
                  if any(k in name for k in keys)), "other (elementwise, "
                  "copies, casts)")
        ms[g] = ms.get(g, 0.0) + t
        by_kernel[evt.key] = (t, evt.count // steps)
    total = sum(ms.values())
    if total <= 0:
        print("profile: torch.profiler saw no device time", flush=True)
        return None
    print(f"profile {what}: wall {wall:.2f} ms per call under the profiler, "
          f"device {total:.2f} ms, idle {max(0.0, 1 - total / wall):.1%} "
          f"(of the unprofiled call: {max(0.0, 1 - total / step_ms):.1%})",
          flush=True)
    for g, t in sorted(ms.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {t:9.3f} ms  {t / total:6.1%}", flush=True)
    print("  top kernels (ms per call, launches per call):", flush=True)
    for k, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {t:8.3f} ms {n:5d}x  {k[:110]}", flush=True)
    return wall, total, ms


# 15. FFA-Net (full width and depth: 3 groups of 19 blocks, width 64) and
# the residual conv UNet (width 32). Neither runs a kernel of the port:
# cuDNN convolutions and plain torch, as the JAX package computes them
# outside any pallas_call.
FFA_SMALL = (64, 96)
FFA_REPS = {"bfloat16": 5, "float32": 2}  # timed 1200×1600 frames
# 3×3 convs of 64 → 64 channels: 2 a block, 19 blocks and a tail conv a
# group, 3 groups, post.0; FLOPs of a frame (the other convs add < 2%).
FFA_CONVS = 118
FFA_TRAIN_STEPS, FFA_TRAIN_EVERY = 6, 3
UNET_REPS = 5


def _zero_launches(label: str, counts: dict) -> None:
    """A path that needs no kernel (FFA-Net, the UNet, the zoo): no kernel
    of the port and no twin."""
    busy = {k: v for k, v in counts.items()
            if k not in ("peak_gib", "secs", "rc") and v}
    if busy:
        fail(f"{label}: launched {busy}; this path runs no kernel of the "
             "port and no twin")


def _ffa_weights(tmp: str) -> str:
    """The seeded FFA-Net as a `.pk` in the reference layout."""
    import torch

    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.models import get_arch

    pk = os.path.join(tmp, "ffa_seed.pk")
    if not os.path.exists(pk):
        torch.manual_seed(SEED)
        torch.save({"step": 0, "max_psnr": 0.0, "max_ssim": 0.0,
                    "psnrs": [], "ssims": [], "losses": [],
                    "model": get_arch(ModelConfig(arch="ffa")).state_dict()},
                   pk)
    return pk


def _ffa_native(pk: str, dtype, dev: str = "cuda"):
    """(model, the protocol's native forward: normalized input, clamped
    output) of the seeded FFA-Net."""
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import (make_native_image_fn,
                                              normalize_hazy)

    model = build_model_and_params(ModelConfig(arch="ffa", dtype=dtype), pk,
                                   torch.device(dev))
    return model, make_native_image_fn(lambda x: model(normalize_hazy(x)),
                                       device=dev)


def phase_ffa_frames(tmp: str):
    """15a, run while the kernels build (it needs none; its times are CUDA
    events on the card): FFA-Net f32 (TF32 off) CUDA against CPU on a
    64×96 frame, the protocol's normalized input, clamped output within
    MODEL_TOL; the 1200×1600 native frame in bf16 and f32 (TF32 off): ms,
    peak memory, bound and a profile of each (the share of NCHW<->NHWC
    layout copies); the UNet-32's frame on the rect canvas 1280×1664,
    bf16. No launch of a port kernel, no twin call. Returns (the counts
    by path, {dtype: FFA ms/frame})."""
    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn
    from dehaze_tpu_torch.models import get_arch

    pk = _ffa_weights(tmp)
    x = np.random.default_rng(SEED).uniform(
        size=(1,) + FFA_SMALL + (3,)).astype(np.float32)
    outs = {dev: _ffa_native(pk, torch.float32, dev)[1](x).cpu()
            for dev in ("cpu", "cuda")}
    d = (outs["cuda"] - outs["cpu"]).abs()
    print(f"FFA-Net {FFA_SMALL[0]}x{FFA_SMALL[1]} f32 (TF32 off) CUDA vs "
          f"CPU, normalized input: max|d|={float(d.max()):.3e} "
          f"mean|d|={float(d.mean()):.3e}", flush=True)
    if not torch.isfinite(outs["cuda"]).all() or float(d.max()) > MODEL_TOL:
        fail(f"FFA-Net f32 CUDA vs CPU beyond {MODEL_TOL:g}")
    frame = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, size=(1,) + FRAME + (3,), dtype=np.uint8)).cuda()
    px = FRAME[0] * FRAME[1]
    flops = FFA_CONVS * px * 64 * 64 * 9 * 2
    paths, ffa_ms = {}, {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        model, run = _ffa_native(pk, dtype)
        run(frame)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with _TwinCounts() as twins:
            ms = cuda_ms(lambda: run(frame), FFA_REPS[dname])
        peak = torch.cuda.max_memory_allocated() / 2**30
        paths["frame_ffa"] = {**read_counts(), **twins}
        y = run(frame)
        # the u8 frame read once, the f32 output written once
        bms, by = bound(px * 3 * (1 + 4), flops, dname)
        print(f"FFA-Net {FRAME[0]}x{FRAME[1]} native frame {dname} (TF32 "
              f"off): {ms:.2f} ms/frame ({FFA_REPS[dname]} frames, CUDA "
              f"events), peak {peak:.2f} GiB, {flops / 1e12:.1f} TFLOP of "
              f"3x3 convs, bound {bms:.2f} ms ({by}), {bms / ms:.1%} of it; "
              f"out range [{float(y.min()):.4f}, {float(y.max()):.4f}]",
              flush=True)
        if tuple(y.shape) != (1,) + FRAME + (3,) or not bool(
                torch.isfinite(y).all()):
            fail(f"FFA-Net {dname} frame: wrong shape or not finite")
        _zero_launches(f"FFA-Net {dname} frame", paths["frame_ffa"])
        prof = _profile(f"one FFA-Net {FRAME[0]}x{FRAME[1]} native frame, "
                        f"{dname}", lambda: run(frame), 1, ms)
        if prof:
            layout = prof[2].get(_LAYOUT, 0.0)
            print(f"  NCHW<->NHWC layout copies: {layout:.3f} ms, "
                  f"{layout / prof[1]:.1%} of the device time", flush=True)
        ffa_ms[dname] = ms
        if dname == "bfloat16":  # the server's micro-batch of 4 frames
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            y = run(frame.expand(4, -1, -1, -1))
            torch.cuda.synchronize()
            print(f"  a micro-batch of 4 frames: peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"({(torch.cuda.max_memory_allocated() - base) / 2**30:.2f}"
                  " GiB above the resident weights and frame)", flush=True)
            if not bool(torch.isfinite(y).all()):
                fail("FFA-Net micro-batch of 4: not finite")
        del model, run, y

    torch.manual_seed(SEED)
    upth = os.path.join(tmp, "unet32_seed.pth")
    torch.save({"state_dict": get_arch(ModelConfig(arch="unet")
                                       ).state_dict()}, upth)
    model = build_model_and_params(ModelConfig(arch="unet"), upth,
                                   torch.device("cuda"))
    run = make_whole_image_fn(model, FRAME[0], FRAME[1], ps=128,
                              square=False, device="cuda")
    run(frame)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _TwinCounts() as twins:
        ms = cuda_ms(lambda: run(frame), UNET_REPS)
    paths["frame_unet"] = {**read_counts(), **twins}
    y = run(frame)
    print(f"UNet-32 {FRAME[0]}x{FRAME[1]} rect canvas 1280x1664 bf16: "
          f"{ms:.2f} ms/frame ({UNET_REPS} frames, CUDA events), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(y.shape) != (1,) + FRAME + (3,) or not bool(
            torch.isfinite(y).all()):
        fail("UNet frame: wrong shape or not finite")
    _zero_launches("UNet frame", paths["frame_unet"])
    return paths, ffa_ms


def _ffa_files(tmp: str) -> dict:
    """The files of phase 15's runs under `tmp`."""
    return {"pk": _ffa_weights(tmp),
            "upth": os.path.join(tmp, "unet32_seed.pth"),  # phase_ffa_frames'
            "long": os.path.join(tmp, "eval_long"),
            "art": os.path.join(tmp, "ffa_native.dhz"),
            "mdir": os.path.join(tmp, "ffa_train"),
            "save": os.path.join(tmp, "log")}


def phase_ffa_runs(tmp: str):
    """15b-e, the runs: FFA-Net's and the UNet's entry points one after
    another in one subprocess (_counted_clis), then `test_long --arch ffa
    --bands 2` as two gloo ranks. No kernel of the port is on these paths,
    so they run on the card while the kernels build (on the host, beside
    nvcc); `phase_ffa` checks what they wrote. Returns (the CLI runs, their
    process's seconds, the two ranks' runs, their seconds)."""
    f = _ffa_files(tmp)
    flags = ["--arch", "ffa", "--input_dir", f["long"]]
    done, secs = _counted_clis([
        ("test_long", flags + ["--weights", f["pk"], "--result_dir",
                               os.path.join(tmp, "res_ffa")], "--arch ffa"),
        ("export", ["--arch", "ffa", "--weights", f["pk"], "--height",
                    FRAME[0], "--width", FRAME[1], "--out", f["art"]],
         "--arch ffa"),
        ("test_long", flags + ["--exported", f["art"], "--result_dir",
                               os.path.join(tmp, "res_ffa_x")],
         "--exported"),
        ("stream", ["--arch", "ffa", "--input_dir",
                    os.path.join(f["long"], "hazy"), "--weights", f["pk"],
                    "--result_dir", os.path.join(tmp, "stream_ffa")],
         "--arch ffa"),
        ("ffa_train", ["--train_dir", os.path.join(tmp, "train"),
                       "--val_dir", os.path.join(tmp, "val"), "--steps",
                       FFA_TRAIN_STEPS, "--eval_step", FFA_TRAIN_EVERY,
                       "--bs", 2, "--crop_size", 240, "--perloss",
                       "--model_dir", f["mdir"]], "--perloss"),
        ("train", ["--arch", "unet", "--train_dir",
                   os.path.join(tmp, "train"), "--val_dir",
                   os.path.join(tmp, "val"), "--train_ps", TRAIN_PS,
                   "--batch_size", TRAIN_BATCH, "--nepoch", 1,
                   "--save_dir", f["save"], "--env", "_smoke"],
         "--arch unet"),
        ("test_long", ["--arch", "unet", "--input_dir", f["long"],
                       "--weights", f["upth"], "--result_dir",
                       os.path.join(tmp, "res_unet")], "--arch unet")])
    spec = json.dumps([["test_long", [str(a) for a in flags + [
        "--weights", f["pk"], "--result_dir", os.path.join(tmp, "res_ffa_b"),
        "--device", "cuda:0", "--dist_backend", "gloo", "--bands", 2]]]])
    t0 = time.perf_counter()
    bands = [_split_runs(o)[0] for o in _ranks(["-c", _RUNNER, spec], 2,
                                               "FFA-Net --bands 2")]
    return done, secs, bands, time.perf_counter() - t0


def phase_ffa(tmp: str, runs):
    """15b-e, the checks of `phase_ffa_runs`' runs (`runs`):
    (b) `cli.test_long --arch ffa` (bf16) on phase 9's pairs, each PSNR
        against the in-process native forward; `cli.export --arch ffa` on
        the card, its artifact bit for bit the eager forward, and
        `test_long --exported` with the `--weights` lines exactly;
        `cli.stream --arch ffa` (each PNG the in-process quantized
        forward); one `serve --arch ffa` request in process;
    (c) `cli.ffa_train` at batch 2 × 240², --perloss (random VGG16), f32
        with the CLI's TF32 default: finite losses, img/s, `ffa_best.pk`
        reloaded strictly gives the logged PSNR;
    (d) `test_long --arch ffa --bands 2`, two gloo ranks on the card: the
        one-process lines within BAND_PSNR_TOL;
    (e) `cli.train --arch unet` (phase 11's set and recipe), its
        model_best.pth reloaded strictly giving the logged PSNR; `cli.
        test_long --arch unet` (square canvas) on phase 9's pairs, each
        PSNR against the in-process forward.
    Every path launches no kernel of the port and calls no twin. The runs'
    host-clock times (s/frame, img/s) were taken while nvcc built the
    kernels on the same host. Returns the launch counts by path."""
    import glob
    import re
    from http.server import ThreadingHTTPServer
    from types import SimpleNamespace

    import numpy as np
    import torch

    from dehaze_tpu_torch.cli.common import build_model_and_params
    from dehaze_tpu_torch.cli.serve import build_dehaze_fn, make_handler
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.data.images import decode_img, encode_img, load_img
    from dehaze_tpu_torch.data.pipeline import (PairedFolder, _val_batches,
                                                val_images)
    from dehaze_tpu_torch.infer.export import load_exported
    from dehaze_tpu_torch.infer.tiled import make_whole_image_fn, quantize_u8
    from dehaze_tpu_torch.ops import metrics as M
    from dehaze_tpu_torch.train.ffa_trainer import FFATrainer
    from dehaze_tpu_torch.utils.convert import load_weights

    paths = {}
    f = _ffa_files(tmp)
    pk, upth, long_dir = f["pk"], f["upth"], f["long"]
    art, mdir, save = f["art"], f["mdir"], f["save"]
    done, secs, outs, band_secs = runs
    names = ("cli.test_long --arch ffa", "cli.export --arch ffa",
             "cli.test_long --exported (FFA)", "cli.stream --arch ffa",
             "cli.ffa_train", "cli.train --arch unet",
             "cli.test_long --arch unet")
    for name, (_, stats) in zip(names, done):
        if stats["rc"] != 0:
            fail(f"{name} exited {stats['rc']}")
        _zero_launches(name, stats)
    print(f"the FFA-Net and UNet CLIs in one process: {secs:.1f}s",
          flush=True)
    (out, stats), (_, ex_stats), (out_x, x_stats), (_, st_stats), \
        (out_t, t_stats), (_, u_stats), (out_u, eu_stats) = done

    # (b) evaluation, export, stream and serve, bf16
    model, run = _ffa_native(pk, torch.bfloat16)
    lines = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out, re.M)
    worst = 0.0
    for (name, psnr, _), (clean, hazy, fname) in zip(
            lines, val_images(PairedFolder(long_dir))):
        y = run(hazy[None])[0]
        ref = float(M.psnr(y, torch.from_numpy(clean).cuda()))
        worst = max(worst, abs(ref - float(psnr)))
    per_frame = float(re.search(r"frames: (\S+) s/frame", out).group(1))
    print(f"cli.test_long --arch ffa (native, bf16): {len(lines)} frames, "
          f"{per_frame:.4f} s/frame after the first, peak "
          f"{stats['peak_gib']:.2f} GiB, run {stats['secs']:.1f}s; "
          f"per-image PSNR vs the in-process forward: max |d| {worst:.2e} "
          "dB", flush=True)
    if len(lines) != 3 or worst > EVAL_PSNR_TOL:
        fail("cli.test_long --arch ffa does not give the in-process PSNRs")
    paths["eval_ffa"] = stats
    base, meta = load_exported(art, "cuda")
    _, hazy, _ = next(val_images(PairedFolder(long_dir)))
    with _TwinCounts() as twins:
        reset_counts()
        same = torch.equal(base(hazy[None]), run(hazy[None]))
        counts = {**read_counts(), **twins}
    print(f"FFA-Net artifact ({meta['canvas']}, "
          f"{os.path.getsize(art) / 1e6:.1f} MB, export run "
          f"{ex_stats['secs']:.1f}s) against the eager forward: "
          f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
    _zero_launches("the FFA-Net artifact", counts)
    if meta["canvas"] != "native" or not same:
        fail("the FFA-Net artifact is not the eager native forward")
    lines_x = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out_x, re.M)
    print(f"cli.test_long --exported (FFA-Net native artifact): lines "
          f"{'equal' if lines_x == lines else 'DIFFERENT'} to --weights', "
          f"run {x_stats['secs']:.1f}s", flush=True)
    if lines_x != lines:
        fail("test_long --exported (FFA) does not print the --weights lines")
    paths["eval_exported_ffa"] = x_stats
    q = quantize_u8(run)
    for src in sorted(glob.glob(os.path.join(long_dir, "hazy", "*.png"))):
        img = load_img(src, u8=True)
        got = load_img(os.path.join(tmp, "stream_ffa",
                                    os.path.basename(src)), u8=True)
        if not np.array_equal(got, q(img[None])[0].cpu().numpy()):
            fail(f"cli.stream --arch ffa: {src} differs from the in-process "
                 "forward")
    print(f"cli.stream --arch ffa: 3 outputs equal to the in-process "
          f"forward, run {st_stats['secs']:.1f}s", flush=True)
    paths["stream_ffa"] = st_stats

    args = SimpleNamespace(weights=pk, train_ps=128, square=False,
                           device="cuda", seed=SEED, max_batch=4)
    with _TwinCounts() as twins:
        reset_counts()
        dehaze, info = build_dehaze_fn(args, ModelConfig(arch="ffa"))
        srv = ThreadingHTTPServer(("127.0.0.1", 0),
                                  make_handler(dehaze, info))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        img = load_img(os.path.join(long_dir, "hazy", "00000.png"), u8=True)
        url = f"http://127.0.0.1:{srv.server_port}"
        try:
            t0 = time.perf_counter()
            req = urllib.request.Request(url + "/dehaze",
                                         data=encode_img(img), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, r.read()
            latency = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            dehaze.batcher.close()
        counts = {**read_counts(), **twins}
    same = status == 200 and np.array_equal(
        decode_img(body, u8=True), q(img[None])[0].cpu().numpy())
    print(f"serve --arch ffa: status {status}, latency {latency:.3f}s (the "
          f"first request of the process), healthz arch {health['arch']}, "
          f"output {'equal' if same else 'DIFFERENT'} to the in-process "
          "forward", flush=True)
    if not same or health["arch"] != "ffa":
        fail("serve --arch ffa did not answer with the native forward")
    _zero_launches("serve --arch ffa", counts)
    paths["serve_ffa"] = counts
    del model, run, base, q

    # (c) cli.ffa_train on phase 11's set
    hist = json.load(open(os.path.join(mdir, "ffa_history.json")))
    img_s = float(re.search(r"steady (\S+) img/s", out_t).group(1))
    print(f"cli.ffa_train FFA-Net b2x240² f32 (TF32 on, the CLI default), "
          f"L1 + perceptual: {FFA_TRAIN_STEPS} steps, losses "
          f"{[round(v, 4) for v in hist['losses']]}, PSNRs "
          f"{[round(v, 4) for v in hist['psnrs']]}; steady {img_s:.2f} "
          f"img/s ({2e3 / img_s:.1f} ms/step), peak "
          f"{t_stats['peak_gib']:.2f} GiB, run {t_stats['secs']:.1f}s",
          flush=True)
    if len(hist["losses"]) != FFA_TRAIN_STEPS or not all(
            math.isfinite(v) for v in hist["losses"]):
        fail("cli.ffa_train: a step's loss is missing or not finite")
    paths["train_ffa"] = t_stats
    best = os.path.join(mdir, "ffa_best.pk")
    payload = torch.load(best, map_location="cpu", weights_only=True)
    tr = FFATrainer(device="cuda")
    tr.model.load_state_dict(load_weights(best, "ffa"), strict=True)
    val, nv = _val_batches(PairedFolder(os.path.join(tmp, "val")), 240, 2,
                           u8=True)
    torch.backends.cudnn.allow_tf32 = True  # the mode the CLI evaluated in
    try:
        psnr = tr.evaluate(val, n_valid=nv)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    print(f"ffa_best.pk (step {payload['step']}) reloaded strictly: PSNR "
          f"{psnr:.4f} vs logged {payload['max_psnr']:.4f} (|d| "
          f"{abs(psnr - payload['max_psnr']):.2e})", flush=True)
    if abs(psnr - payload["max_psnr"]) > RELOAD_TOL:
        fail("the reloaded ffa_best.pk does not give the logged PSNR")
    del tr

    # (d) two gloo ranks, the frame's rows in 2 bands
    what = "cli.test_long --arch ffa --bands 2"
    for ln in outs[0][0].splitlines():
        print(f"  {what} | {ln}", flush=True)
    band_lines = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", outs[0][0],
                            re.M)
    worst = max(abs(float(a[1]) - float(b[1]))
                for a, b in zip(band_lines, lines))
    per_frame = float(re.search(r"frames: (\S+) s/frame",
                                outs[0][0]).group(1))
    print(f"{what} (2 gloo ranks on one card, bf16): {per_frame:.4f} "
          f"s/frame after the first, peak per rank "
          f"{[round(o[1]['peak_gib'], 2) for o in outs]} GiB; PSNRs against "
          f"one process: max |d| {worst:.2e} dB (tolerance "
          f"{BAND_PSNR_TOL:g}); {band_secs:.1f}s", flush=True)
    if any(o[1]["rc"] for o in outs) or len(band_lines) != 3 \
            or worst > BAND_PSNR_TOL:
        fail(f"{what} does not give the one-process PSNRs")
    band = {k: sum(o[1][k] for o in outs) for k in outs[0][1]
            if k not in ("peak_gib", "secs", "rc")}
    _zero_launches(what, band)
    paths["eval_bands_ffa"] = band

    # (e) cli.train --arch unet
    ev = [json.loads(ln) for f in glob.glob(os.path.join(
        save, "unet_smoke", "*.jsonl")) for ln in open(f)]
    epoch = next(e for e in ev if e["kind"] == "epoch")
    losses = epoch["step_losses"]
    print(f"cli.train --arch unet UNet-32 b{TRAIN_BATCH}x{TRAIN_PS}² bf16 CR "
          f"on: {len(losses)} steps, losses {[round(v, 4) for v in losses]}"
          f"; steady {epoch['img_per_s']:.2f} img/s, peak "
          f"{u_stats['peak_gib']:.2f} GiB, run {u_stats['secs']:.1f}s",
          flush=True)
    if len(losses) != N_TRAIN // TRAIN_BATCH or not all(
            math.isfinite(v) for v in losses):
        fail("cli.train --arch unet: a step's loss is missing or not finite")
    paths["train_unet"] = u_stats
    best = os.path.join(save, "unet_smoke", "models", "model_best.pth")
    logged = torch.load(best, weights_only=True)["extra"]["psnr"]
    model = build_model_and_params(ModelConfig(arch="unet"), best,
                                   torch.device("cuda"))
    val, nv = _val_batches(PairedFolder(os.path.join(tmp, "val")), TRAIN_PS,
                           TRAIN_BATCH, u8=True)
    with torch.no_grad():
        ps = torch.cat([M.batch_psnr(torch.clamp(model(
            torch.from_numpy(n).cuda().float() / 255.0), 0.0, 1.0),
            torch.from_numpy(c).cuda().float() / 255.0) for c, n in val])
    psnr = float(ps[:nv].mean())
    print(f"UNet model_best.pth reloaded strictly: PSNR {psnr:.4f} vs "
          f"logged {logged:.4f}", flush=True)
    if abs(psnr - logged) > RELOAD_TOL:
        fail("the reloaded UNet model_best.pth does not give the logged PSNR")
    # the UNet's evaluation on the square canvas, as the Uformer's
    model = build_model_and_params(ModelConfig(arch="unet"), upth,
                                   torch.device("cuda"))
    lines = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out_u, re.M)
    worst = 0.0
    for (_, psnr, _), (clean, hazy, _) in zip(
            lines, val_images(PairedFolder(long_dir))):
        y = make_whole_image_fn(model, *hazy.shape[:2], 128, square=True,
                                device="cuda")(hazy[None])[0]
        worst = max(worst, abs(float(M.psnr(
            y, torch.from_numpy(clean).cuda())) - float(psnr)))
    per_frame = float(re.search(r"frames: (\S+) s/frame", out_u).group(1))
    print(f"cli.test_long --arch unet (square canvas 1664², bf16): "
          f"{per_frame:.4f} s/frame after the first, run "
          f"{eu_stats['secs']:.1f}s; per-image PSNR vs the in-process "
          f"forward: max |d| {worst:.2e} dB", flush=True)
    if len(lines) != 3 or worst > EVAL_PSNR_TOL:
        fail("cli.test_long --arch unet does not give the in-process PSNRs")
    paths["eval_unet"] = eu_stats
    return paths

# Phase 17: the zoo's 17 models at their published sizes on CIFAR
# geometry (32², 10 classes). The transformer families take the geometry
# of the JAX package's parity cases (tests/test_zoo_parity.py): ViT and
# ConViT 4×4 patches, the Mixer 8×8, AlterNet 4×4 windows (its default 7
# tiles none of its maps at 32², which both packages refuse); Swin keeps
# its window 7 and pools, so its windows collapse to 4, 4, 2, 1.
ZOO_MODELS = [
    ("resnet_dnn_18", {}), ("preresnet_18", {}), ("seresnet_18", {}),
    ("cbamresnet_18", {}), ("resnext_50", {}), ("wideresnet_50", {}),
    ("resnet_mcdo_smoothing_18", {}), ("vgg_16", {}), ("prevgg_11", {}),
    ("alexnet", {}), ("mobilenet", {}), ("vit_ti", {"patch_size": 4}),
    ("pit_ti", {}), ("mixer_ti", {"patch_size": 8}), ("swin_t", {}),
    ("convit_ti", {"patch_size": 4}), ("alternet_18", {"window_size": 4})]
ZOO_BATCH = 128      # timed batch
ZOO_CHECK = 4        # images of the card-against-CPU check
ZOO_REPS = (10, 5)   # forwards timed, forwards per synchronize
ZOO_FIXTURE = os.path.join(REPO, "tests", "data", "uformer_e4_bf16")


def _pack(obj, out: bytearray) -> None:
    """msgpack-python's `packb` encoding of the subset flax writes (maps
    with their keys sorted, str, bytes, ints, floats, None, bools, tuples
    as arrays, numpy arrays as flax's ext 1), byte for byte."""
    import struct

    import numpy as np

    def head(n, fix, fixmax, codes):
        if n <= fixmax and fix is not None:
            out.append(fix | n)
            return
        for code, fmt, lim in codes:
            if n < lim:
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError("too long for msgpack")

    big = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
    if obj is None or obj is True or obj is False:
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif isinstance(obj, int):
        if 0 <= obj < 128 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            for code, fmt, lo, hi in (
                    (0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
                    (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64),
                    (0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
                    (0xD2, ">i", -(1 << 31), 0),
                    (0xD3, ">q", -(1 << 63), 0)):
                if lo <= obj < hi:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode()
        head(len(b), 0xA0, 31, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                                (0xDB, ">I", 1 << 32)))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        head(len(obj), None, -1, ((0xC4, ">B", 1 << 8),
                                  (0xC5, ">H", 1 << 16),
                                  (0xC6, ">I", 1 << 32)))
        out += obj
    elif isinstance(obj, (list, tuple)):
        head(len(obj), 0x90, 15, big)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        head(len(obj), 0x80, 15, ((0xDE, ">H", 1 << 16),
                                  (0xDF, ">I", 1 << 32)))
        for k in sorted(obj):  # flax's tree_map copy sorts the keys
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        rec = bytearray()
        _pack((obj.shape, obj.dtype.name, obj.tobytes("C")), rec)
        n = len(rec)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + (1, 2, 4, 8, 16).index(n))
        else:
            head(n, None, -1, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                               (0xC9, ">I", 1 << 32)))
        out.append(1)
        out += rec
    else:
        raise TypeError(f"cannot pack {type(obj)}")


def pack_jax_checkpoint(epoch: int, params: dict, extra: dict) -> bytes:
    """The bytes `dehaze_tpu.train.checkpoint.save_checkpoint(path, epoch,
    params, None, extra)` writes (params a tree of dicts of float arrays
    under 2**30 bytes each), written without flax or msgpack."""
    inner = bytearray()
    _pack(params, inner)
    out = bytearray()
    _pack({"epoch": epoch, "params": bytes(inner), "opt_state": b"",
           "extra": json.dumps(extra)}, out)
    return bytes(out)


def phase_zoo(tmp: str):
    """(a) The zoo: each of ZOO_MODELS built by `zoo.get_model` on the card
    from a seeded torch init, eval mode: f32 (TF32 off) logits of
    ZOO_CHECK images against the port's CPU forward of the same weights
    (MODEL_TOL; the MC-dropout model with the same CPU generator on both
    sides, so the same masks), then a batch of ZOO_BATCH timed in bf16 and
    f32 by `zoo.checkpoint.measure_executive_time` (CUDA events): ms per
    batch, images/s, peak device memory. No kernel of the port runs on
    this path: every launch count must stay 0. (b) `.msgpack` on this host
    (no flax, no msgpack): the committed fixture read by the port's reader
    and held to its SHA-256s; a Uformer-32 state_dict written in flax's
    format (`pack_jax_checkpoint`) read back and timed; then
    `python -m dehaze_tpu_torch.cli.test_long` with --weights the fixture
    and with --weights a `.pth` of the same state_dict on phase 9's pairs:
    the same per-image PSNRs, K1 and K2 launched. Returns the launch
    counts of the zoo path and of the two evaluations."""
    import hashlib
    import re

    import torch

    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.models.uformer import Uformer
    from dehaze_tpu_torch.train.checkpoint import load_jax_checkpoint
    from dehaze_tpu_torch.utils.convert import load_weights
    from dehaze_tpu_torch.zoo import get_model
    from dehaze_tpu_torch.zoo.checkpoint import (count_parameters,
                                                 measure_executive_time)

    reset_counts()
    g = torch.Generator().manual_seed(SEED)
    x_cpu = torch.randn(ZOO_CHECK, 3, 32, 32, generator=g)
    n_rep, chunk = ZOO_REPS
    for name, kw in ZOO_MODELS:
        torch.manual_seed(SEED)
        model = get_model(name, num_classes=10, image_size=32,
                          device="cuda", **kw).eval()
        cpu = get_model(name, num_classes=10, image_size=32, **kw).eval()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        mc = "mcdo" in name

        def gens():
            return ({"dropout": torch.Generator().manual_seed(SEED)} if mc
                    else None)

        with torch.inference_mode():
            got = model(x_cpu.cuda(), generators=gens()).float().cpu()
            want = cpu(x_cpu, generators=gens())
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or got.shape != (ZOO_CHECK, 10) \
                or err > MODEL_TOL:
            fail(f"zoo {name}: card against CPU max |d| {err:.2e} "
                 f"(tolerance {MODEL_TOL}), shape {tuple(got.shape)}")
        del cpu
        ms = {}
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            timed = model
            if dt != torch.float32:
                timed = get_model(name, num_classes=10, image_size=32,
                                  dtype=dt, device="cuda", **kw).eval()
                timed.load_state_dict(model.state_dict())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            secs = measure_executive_time(
                timed, size=(ZOO_BATCH, 3, 32, 32), n=n_rep, seed=SEED,
                chunk=chunk, generators=({"dropout": torch.Generator(
                    "cuda").manual_seed(SEED)} if mc else None))
            ms[dname] = (secs * 1e3,
                         torch.cuda.max_memory_allocated() / 2**30)
        print(f"zoo {name}: {count_parameters(model) / 1e6:.2f}M params, "
              f"card vs CPU f32 max |d| {err:.2e}; batch {ZOO_BATCH} at 32²: "
              + "; ".join(f"{d} {m:.3f} ms ({ZOO_BATCH / m * 1e3:.0f} "
                          f"img/s, peak {p:.2f} GiB)"
                          for d, (m, p) in ms.items()), flush=True)
        del model
    zoo = read_counts()
    if any(zoo.values()):
        fail(f"zoo: kernels of the port launched {zoo}; the zoo runs none")
    torch.cuda.empty_cache()

    with open(ZOO_FIXTURE + ".json") as f:
        meta = json.load(f)
    t0 = time.perf_counter()
    sd = load_weights(ZOO_FIXTURE + ".msgpack")
    secs_fixture = time.perf_counter() - t0
    sha = {k: hashlib.sha256(v.float().contiguous().numpy().tobytes())
           .hexdigest() for k, v in sd.items()}
    if sha != meta["sha256"]:
        bad = sorted(k for k in meta["sha256"] if sha.get(k) !=
                     meta["sha256"][k])
        fail(f"msgpack fixture: {len(bad)} tensors differ from their "
             f"SHA-256, e.g. {bad[:3]}")
    torch.manual_seed(SEED)
    big = Uformer(ModelConfig()).state_dict()
    tree: dict = {}
    for k, v in big.items():
        node = tree
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.numpy()
    path32 = os.path.join(tmp, "uformer32.msgpack")
    with open(path32, "wb") as f:
        f.write(pack_jax_checkpoint(7, tree, {"psnr": 1.0}))
    nbytes = sum(v.numel() * 4 for v in big.values())
    t0 = time.perf_counter()
    back = load_jax_checkpoint(path32)
    secs32 = time.perf_counter() - t0
    for k, v in big.items():
        node = back["params"]
        for part in k.split("."):
            node = node[part]
        if not torch.equal(torch.from_numpy(node), v):
            fail(f"msgpack round trip: {k} differs")
    print(f"msgpack on this host (no flax, no msgpack): the fixture "
          f"({os.path.getsize(ZOO_FIXTURE + '.msgpack')} bytes, bf16, "
          f"{len(sha)} tensors) read and bridged in {secs_fixture:.3f} s, "
          f"its SHA-256s equal; a Uformer-32 checkpoint ({len(big)} "
          f"float32 leaves, {nbytes / 1e6:.1f} MB of params, "
          f"{os.path.getsize(path32) / 1e6:.1f} MB file) read in "
          f"{secs32:.3f} s", flush=True)

    pth = os.path.join(tmp, "fixture.pth")
    torch.save({"state_dict": sd}, pth)
    long_dir = os.path.join(tmp, "eval_long")
    base = ["--input_dir", long_dir, "--seed", SEED, "--no-save_images",
            *meta["flags"]]
    runs, secs = _counted_clis([
        ("test_long", base + ["--weights", ZOO_FIXTURE + ".msgpack",
                              "--result_dir", os.path.join(tmp, "zm")],
         "--weights fixture.msgpack"),
        ("test_long", base + ["--weights", pth, "--result_dir",
                              os.path.join(tmp, "zp")],
         "--weights fixture.pth")])
    lines, counts = [], {}
    for (out, stats), what in zip(runs, ("msgpack", "pth")):
        if stats["rc"] != 0:
            fail(f"cli.test_long --weights {what} exited {stats['rc']}")
        found = re.findall(r"^(\S+): PSNR (\S+) SSIM (\S+)$", out, re.M)
        if len(found) != 3:
            fail(f"cli.test_long --weights {what}: {len(found)} frames")
        lines.append(found)
        k1 = stats["k1_fwd"] + stats["k1_fwd_tc"]
        if not k1 or not stats["k2"] or stats["twin_k1"] or stats["twin_k2"]:
            fail(f"cli.test_long --weights {what}: K1 {k1}, K2 "
                 f"{stats['k2']}, twins {stats['twin_k1']}/"
                 f"{stats['twin_k2']}; want K1 and K2 and no twin")
        for key in ("k1_fwd", "k1_fwd_tc", "k2"):
            counts[key] = counts.get(key, 0) + stats[key]
    if lines[0] != lines[1]:
        fail(f"cli.test_long: the .msgpack gives {lines[0]}, the .pth "
             f"{lines[1]}")
    print(f"cli.test_long on 3 {FRAME[0]}x{FRAME[1]} pairs, Uformer "
          f"embed_dim 4 (bf16): --weights fixture.msgpack and --weights "
          f".pth give the same per-image PSNR and SSIM "
          f"({', '.join(p for _, p, _ in lines[0])} dB); K1 "
          f"{counts['k1_fwd'] + counts['k1_fwd_tc']} and K2 {counts['k2']} "
          f"launches over both runs ({secs:.1f} s)", flush=True)
    return {"zoo": zoo, "test_long_msgpack": counts}


# 17b: the zoo's evaluation harness. Two registry models at their published
# widths on CIFAR geometry (ViT-Ti with the parity cases' 4×4 patches) and
# the MC-dropout ResNet-18 for n_ff; f32 card-against-CPU checks on
# ZH_CHECK images (the attacks on ZH_ATTACK), CLI runs on ZH_ROWS rows.
ZH_MODELS = (("resnet_dnn_18", {}), ("vit_ti", {"patch_size": 4}))
ZH_MC = "resnet_mcdo_smoothing_18"
ZH_BATCH = 128      # the harness's batch, timed and in the CLI runs
ZH_ROWS = 512       # CIFAR-10 test rows: 4 batches
ZH_TIME_ROWS = 10000  # the timed stream: the CIFAR-10 test set's size
ZH_TIME_REPS = 3    # timed passes over it; the median and the spread
ZH_CHECK = 32       # images of the card-against-CPU `evaluate.test`
ZH_ATTACK = 8       # images of the card-against-CPU attacks
ZH_PGD = {"eps": 8 / 255, "alpha": 2 / 255, "steps": 10}
# card against CPU in f32 (TF32 off): probabilities differ by the sum
# orders of cuDNN/cuBLAS and oneDNN (~1e-6), so NLL, Brier, ECE, ECE± and
# CEC within 1e-4; a confusion-matrix cell may move only for a sample
# whose top-2 probabilities, or whose confidence and a cm edge, lie within
# 1e-5.
ZH_TOL = 1e-4
# the CLI runs on the card against this process on the card, in the CLI's
# mode (torch's defaults: cuDNN TF32 on, cuBLAS TF32 off): 1e-5 on the
# metrics (printed values: their last digit) and on the Fourier CSVs
ZH_CLI_TOL = 1e-5


def _zoo_files(tmp: str) -> str:
    """Seeded CIFAR-10 pickles (ZH_ROWS test rows; ZT_ROWS training rows
    for phase 17c, drawn from a stream of their own so that every other
    file is the one phase 17b was set against), CIFAR-10-C `fog`
    (ZH_ROWS rows at intensity 1), CIFAR-10-P `gaussian_noise` (16
    sequences of 8 frames) and a PNG ImageFolder of 2 classes (8 images of
    36-63 px each) among 10 class directories (`evaluate.topk` needs 5
    classes, in the JAX package too), under one root."""
    import pickle

    import numpy as np

    from dehaze_tpu_torch.data.images import save_img

    root = os.path.join(tmp, "zoo_data")
    rng = np.random.default_rng(SEED)
    c10 = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(c10)
    more = np.random.default_rng(SEED + 1)
    for f, n in [(f"data_batch_{i}", 16) for i in range(1, 6)] + [
            ("test_batch", ZH_ROWS)]:
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        labels = rng.integers(0, 10, n).tolist()
        if f != "test_batch":  # 17c's training rows, from their own stream
            extra = ZT_ROWS // 5 - n
            data = np.concatenate([data, more.integers(
                0, 256, (extra, 3072), dtype=np.uint8)])
            labels += more.integers(0, 10, extra).tolist()
        with open(os.path.join(c10, f), "wb") as fh:
            pickle.dump({b"data": data, b"labels": labels}, fh)
    for folder, name, shape in (
            ("CIFAR-10-C", "fog", (ZH_ROWS, 32, 32, 3)),
            ("cifar-10-p", "gaussian_noise", (16, 8, 32, 32, 3))):
        os.makedirs(os.path.join(root, folder))
        np.save(os.path.join(root, folder, name + ".npy"),
                rng.integers(0, 256, shape, dtype=np.uint8))
    np.save(os.path.join(root, "CIFAR-10-C", "labels.npy"),
            rng.integers(0, 10, ZH_ROWS))
    for c in range(10):
        d = os.path.join(root, "imagenet", "val", f"class{c}")
        os.makedirs(d)
        for i in range(8 if c < 2 else 0):
            h, w = rng.integers(36, 64, 2)
            save_img(os.path.join(d, f"{i}.png"),
                     rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return root


def _near_ties(p, edges) -> int:
    import numpy as np

    top = np.sort(p, axis=1)
    close = top[:, -1] - top[:, -2] < 1e-5
    for e in edges:
        close |= np.abs(top[:, -1] - e) < 1e-5
    return int(close.sum())


def _metrics_gap(label: str, got, want, p, tol: float) -> float:
    """Fails unless `evaluate.test`'s tuples agree: NLL, Brier, ECE and
    ECE± within tol, the cms and the bins' counts equal but for near-ties.
    One near-tie sample moves at most 6 entries: an argmax flip 2 in each
    of the two group cms that hold it (cutoff 0 and one side of 0.9), a
    confidence across an edge 2 more (leaving one cm or bin for the next).
    Returns the largest gap of the four."""
    import numpy as np

    gap = max(abs(float(got[i]) - float(want[i])) for i in (0, 8, 12, 13))
    cms = [np.asarray(m) for g in (got, want)
           for m in [c for pair in g[2] for c in pair] + [g[9]]]
    half = len(cms) // 2
    moved = sum(int(np.abs(a - b).sum()) for a, b in zip(cms[:half],
                                                         cms[half:]))
    ties = _near_ties(p, list(want[1]) + list(np.linspace(0, 1, 11)))
    if not np.isfinite(gap) or gap > tol or moved > 6 * ties:
        fail(f"{label}: NLL/Brier/ECE/ECE± gap {gap:.2e} (tolerance "
             f"{tol}), cm entries moved {moved} with {ties} near-ties")
    return gap


def _zoo_cli_held(x, y, root, seqs, model, second, texts, out, secs,
                  n_runs):
    """Phase 17b (b): each `cli.zoo` run's output (`texts` by label, the
    files under `out`) held to this process's run of `model` (the CLI's
    `--ckpt`) and `second` (its `--ensemble` member) on the card, in the
    mode the CLI ran in."""
    import re

    import numpy as np
    import torch

    from dehaze_tpu_torch.zoo import adversarial as ADV
    from dehaze_tpu_torch.zoo import data as ZD
    from dehaze_tpu_torch.zoo import evaluate as ZE
    from dehaze_tpu_torch.zoo import fourier as ZF
    from dehaze_tpu_torch.zoo import get_model
    from dehaze_tpu_torch.zoo.ensemble import Ensemble, stack_state_dicts

    def cpu_gen():
        return torch.Generator().manual_seed(SEED)

    name = "resnet_dnn_18"

    def held(label, path, metrics):
        with open(path) as f:
            js = json.load(f)
        want = {"nll": metrics[0], "acc": metrics[3][0], "acc90":
                metrics[3][1], "top5": metrics[7], "brier": metrics[8],
                "ece": metrics[12], "ecse": metrics[13]}
        gap = max(abs(js[k] - v) for k, v in want.items())
        if not gap <= ZH_CLI_TOL:
            fail(f"cli.zoo eval {label}: JSON {js} against this process's "
                 f"{want}")
        return js

    batches = ZD.batches(x, y, ZH_BATCH)
    js = held("cifar10", out["eval.json"], ZE.test(model, batches))
    with open(out["eval.csv"]) as f:
        row = f.read().strip().split(",")
    if row[0] != "cifar10" or abs(float(row[1]) - js["nll"]) > 1e-9:
        fail(f"cli.zoo eval --metrics_csv row {row[:3]}")
    xf, yf = ZD.load_cifar_c(root, "fog", 1)
    held("--ctype", out["ctype.json"],
         ZE.test(model, ZD.batches(xf, yf, ZH_BATCH)))
    ens = Ensemble.stacked(model, stack_state_dicts(
        [model.state_dict(), second.state_dict()]))
    held("--ensemble", out["ens.json"], ZE.test(ens, ZD.batches(
        x, y, ZH_BATCH)))
    torch.manual_seed(0)  # the CLI's init without --ckpt
    inet = get_model(name, num_classes=10, image_size=32,
                     device="cuda").eval()
    held("--dataset imagenet", out["inet.json"], ZE.test(
        inet, ZD.imagenet_batches(16, root=root, size=32)))
    cons, cec = ZE.test_perturbation(model, [seqs])
    printed = [float(v) for v in re.findall(
        r"consistency: (\S+), CEC: (\S+)$", texts["perturbation "])[0]]
    if abs(printed[0] - cons) > 6e-5 or abs(printed[1] - cec) > 6e-5:
        fail(f"cli.zoo perturbation printed {printed}, this process "
             f"{cons:.6f}, {cec:.6f}")
    xs = ZE.to_nchw(x[:ZH_BATCH], "cuda").contiguous()
    ys = torch.as_tensor(y[:ZH_BATCH]).cuda()

    def acc(images):
        with torch.inference_mode():
            logits = model(images, generators={"dropout": cpu_gen()})
        return float((logits.argmax(-1) == ys).float().mean())

    fg = ADV.fgsm(model, xs, ys, eps=ZH_PGD["eps"], generator=cpu_gen())[0]
    adv = {"fgsm": fg,
           "pgd": ADV.pgd(model, xs, ys, generator=cpu_gen(), **ZH_PGD)[0],
           "random": ADV.random_attack(xs, ys, eps=ZH_PGD["eps"],
                                       generator=cpu_gen())[0],
           "fgsm --freq": xs + ADV.freq_mask(fg - xs, 1.0)}
    clean = acc(xs)
    accs = []
    for label, images in adv.items():
        got = [float(v) for v in re.findall(
            r"clean acc: (\S+), adv acc: (\S+)$", texts[f"attack {label}"])[0]]
        want = (clean, acc(images))
        # one example may move where cuDNN's backward sums in another order
        if abs(got[0] - want[0]) > 6e-5 or abs(got[1] - want[1]) > \
                1 / ZH_BATCH + 6e-5:
            fail(f"cli.zoo attack {label}: printed {got}, this process "
                 f"{want}")
        accs.append(f"{label} {got[1]:.4f}")
    lat = ZF.collect_latents(model, x[:ZH_BATCH])
    fgap = 0.0
    for f, want in (("highfreq_delta.csv", ZF.high_freq_deltas(lat)),
                    ("variance.csv", ZF.variance_latents(lat))):
        got = np.loadtxt(os.path.join(out["fourier"], f), delimiter=",")
        if got.shape != want.shape or not np.allclose(got, want,
                                                      rtol=ZH_CLI_TOL,
                                                      atol=ZH_CLI_TOL):
            fail(f"cli.zoo fourier {f}: {got} against {want}")
        fgap = max(fgap, float(np.abs(got - want).max()))
    ips = {label.split(" ", 1)[1]: float(re.findall(
        r"throughput: (\S+) img/s", text)[0])
        for label, text in texts.items() if label.startswith("predtime")}
    print(f"cli.zoo on the card ({secs:.1f} s, {n_runs} runs in one "
          f"process): eval, --ctype, --ensemble and --dataset imagenet equal "
          f"this process's metrics (acc {js['acc']:.4f}, NLL "
          f"{js['nll']:.4f}); perturbation consistency {cons:.4f}; attack "
          f"clean {clean:.4f}, adv {', '.join(accs)}; fourier's CSVs "
          f"({len(lat)} latents) within {fgap:.1e}; predtime img/s at "
          f"batch {ZH_BATCH}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ips.items())
          + "; 0 launches of every kernel", flush=True)



def phase_zoo_harness(tmp: str):
    """The zoo's evaluation harness (`zoo.data`, `evaluate`, `adversarial`,
    `fourier`, `ensemble`, `cli.zoo`; plain torch, no kernel of the port).
    (a) In this process, f32 with TF32 off, for each of ZH_MODELS (seeded
    init) on the card against the port's CPU run of the same weights:
    `evaluate.test` on ZH_CHECK CIFAR-10 rows, `test_perturbation` on two
    CIFAR-10-P sequences, the input gradient of the attacks' loss (within
    1e-4 of its largest entry, the same sign wherever |g| > 1e-4·max|g|),
    FGSM there and 10-step PGD (its random start and per-step streams from
    one CPU generator on both sides; the share of pixels that end apart is
    printed); `evaluate.test` of ZH_MC with n_ff = 4, the masks from one
    CPU generator on both sides. (b) `python -m dehaze_tpu_torch.cli.zoo`
    eval (CIFAR pickles with --json_out and --metrics_csv, --ctype,
    --ensemble, --dataset imagenet), perturbation, attack (fgsm, pgd,
    random, fgsm --freq), fourier and predtime (f32 and --bf16, both
    models) on the card, in one subprocess (_counted_clis) started before
    (a) and run beside it, on ResNet-18
    `.pth` files of (a)'s weights; each output held to this process's run
    on the card with cuDNN TF32 on, as the CLI runs (_zoo_cli_held). (c)
    ms per batch of ZH_BATCH over ZH_TIME_ROWS seeded rows, ZH_TIME_REPS
    passes (median and spread): `evaluate.test` (the forward, the softmax
    and the host's numpy metrics) against the forward alone
    (`measure_executive_time`), bf16 and f32, and the f32 forward with
    cuDNN TF32 on (predtime's mode). Every path launches no
    kernel of the port and calls no twin. Returns the launch counts of
    (a) and of each subcommand's runs."""
    import importlib.util

    import numpy as np
    import torch

    from dehaze_tpu_torch.zoo import adversarial as ADV
    from dehaze_tpu_torch.zoo import data as ZD
    from dehaze_tpu_torch.zoo import evaluate as ZE
    from dehaze_tpu_torch.zoo import get_model
    from dehaze_tpu_torch.zoo.checkpoint import measure_executive_time

    root = _zoo_files(tmp)
    _, (x, y), _, _ = ZD.get_dataset("cifar10", root)
    seqs = ZD.load_cifar_p(root, "gaussian_noise")
    reset_counts()

    def pair(name, kw, seed=SEED):
        torch.manual_seed(seed)
        card = get_model(name, num_classes=10, image_size=32,
                         device="cuda", **kw).eval()
        cpu = get_model(name, num_classes=10, image_size=32, **kw).eval()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        return card, cpu

    def cpu_gen():
        return torch.Generator().manual_seed(SEED)

    pairs = {name: pair(name, kw) for name, kw in ZH_MODELS}
    models = {name: card for name, (card, _) in pairs.items()}
    # (b)'s runs go on in a subprocess while (a) runs here: neither is
    # timed
    cli_model = "resnet_dnn_18"
    model = models[cli_model]
    pth, pth2 = (os.path.join(tmp, f"zoo_{i}.pth") for i in (1, 2))
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()}}, pth)
    second, _ = pair(cli_model, {}, seed=SEED + 1)
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               second.state_dict().items()}}, pth2)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out = {k: os.path.join(tmp, f"zoo_{k}") for k in
           ("eval.json", "eval.csv", "ctype.json", "ens.json", "inet.json",
            "fourier")}
    base = ["--name", cli_model, "--root", root, "--batch_size", ZH_BATCH]
    cifar = base + ["--dataset", "cifar10", "--ckpt", pth]
    attack = cifar + ["--n_examples", ZH_BATCH, "--eps", ZH_PGD["eps"],
                      "--seed", SEED]
    runs = [
        ("eval", cifar + ["--json_out", out["eval.json"], "--metrics_csv",
                          out["eval.csv"]], "cifar10"),
        ("eval", base + ["--ctype", "fog", "--ckpt", pth, "--json_out",
                         out["ctype.json"]], "--ctype fog"),
        ("eval", cifar + ["--ensemble", pth2, "--json_out", out["ens.json"]],
         "--ensemble"),
        ("eval", ["--name", cli_model, "--root", root, "--dataset",
                  "imagenet", "--image_size", 32, "--batch_size", 16,
                  "--json_out", out["inet.json"]], "--dataset imagenet"),
        ("perturbation", base[:4] + ["--batch_size", 16, "--ckpt", pth], ""),
        ("attack", attack + ["--method", "fgsm"], "fgsm"),
        ("attack", attack + ["--method", "pgd", "--alpha", ZH_PGD["alpha"],
                             "--steps", ZH_PGD["steps"]], "pgd"),
        ("attack", attack + ["--method", "random"], "random"),
        ("attack", attack + ["--method", "fgsm", "--freq", 1.0],
         "fgsm --freq"),
        ("fourier", cifar + ["--out", out["fourier"]]
         + ([] if has_mpl else ["--out_plot", ""]), ""),
    ] + [("predtime", ["--name", n, "--root", root, "--dataset", "cifar10",
                       "--batch_size", ZH_BATCH, "--n", 50]
          + sum((["--" + k, v] for k, v in kw.items()), []) + bf,
          f"{n} {'bf16' if bf else 'f32'}")
         for n, kw in ZH_MODELS for bf in ([], ["--bf16"])]
    behind = cf.ThreadPoolExecutor(1)
    clis = behind.submit(_counted_clis, [
        ("zoo", [sub] + args, f"{sub} {label}") for sub, args, label in runs])
    for name, kw in ZH_MODELS:
        card, cpu = pairs[name]
        xc, yc = x[:ZH_CHECK], y[:ZH_CHECK]
        want = ZE.test(cpu, ZD.batches(xc, yc, 16))
        got = ZE.test(card, ZD.batches(xc, yc, 16))
        p = ZE.make_predict_fn(cpu)(xc).numpy()
        gap = _metrics_gap(f"zoo harness {name} evaluate.test", got, want,
                           p, ZH_TOL)
        cons = [ZE.test_perturbation(m, [seqs[:2]]) for m in (card, cpu)]
        if cons[0][0] != cons[1][0] or not abs(cons[0][1] - cons[1][1]) \
                <= ZH_TOL:
            fail(f"zoo harness {name} test_perturbation: card {cons[0]}, "
                 f"CPU {cons[1]}")
        xa = ZE.to_nchw(x[:ZH_ATTACK], "cpu").contiguous()
        ya = torch.as_tensor(y[:ZH_ATTACK])
        g_cpu = ADV.input_grad(cpu, xa, ya)
        g_card = ADV.input_grad(card, xa.cuda(), ya.cuda()).cpu()
        scale = float(g_cpu.abs().max())
        big = g_cpu.abs() > 1e-4 * scale
        gerr = float((g_card - g_cpu).abs().max()) / scale
        flips = int((torch.sign(g_card) != torch.sign(g_cpu))[big].sum())
        if not scale > 0 or gerr > ZH_TOL or flips:
            fail(f"zoo harness {name}: input gradient card against CPU "
                 f"{gerr:.2e} of its max (tolerance {ZH_TOL}), {flips} "
                 "sign flips where |g| > 1e-4·max|g|")
        f_cpu, _ = ADV.fgsm(cpu, xa, ya, eps=ZH_PGD["eps"])
        f_card, _ = ADV.fgsm(card, xa.cuda(), ya.cuda(), eps=ZH_PGD["eps"])
        if not torch.equal(f_card.cpu()[big], f_cpu[big]):
            fail(f"zoo harness {name}: FGSM card and CPU differ where "
                 "|g| > 1e-4·max|g|")
        p_cpu, _ = ADV.pgd(cpu, xa, ya, generator=cpu_gen(), **ZH_PGD)
        p_card, _ = ADV.pgd(card, xa.cuda(), ya.cuda(), generator=cpu_gen(),
                            **ZH_PGD)
        apart = float(((p_card.cpu() - p_cpu).abs() > 1e-5).float().mean())
        reach = float((p_card.cpu() - xa).abs().max())
        if apart > 0.01 or reach > ZH_PGD["eps"] + 1e-5:
            fail(f"zoo harness {name}: 10-step PGD card against CPU: "
                 f"{apart:.2%} of the pixels apart (at most 1%), reach "
                 f"{reach:.4f} (eps {ZH_PGD['eps']:.4f})")
        print(f"zoo harness {name}: card vs CPU f32, evaluate.test on "
              f"{ZH_CHECK} rows max gap {gap:.2e} (NLL {got[0]:.6f} / "
              f"{want[0]:.6f}), perturbation consistency {cons[0][0]:.4f}, "
              f"CEC {cons[0][1]:.6f} / {cons[1][1]:.6f}; attack gradient "
              f"{gerr:.2e} of its max, 0 sign flips on {int(big.sum())} of "
              f"{big.numel()}; FGSM equal there; 10-step PGD "
              f"{apart:.3%} of the pixels apart", flush=True)
    del pairs, cpu
    card, cpu = pair(ZH_MC, {})
    xc, yc = x[:ZH_CHECK], y[:ZH_CHECK]
    want = ZE.test(cpu, ZD.batches(xc, yc, 16), n_ff=4, generator=cpu_gen())
    got = ZE.test(card, ZD.batches(xc, yc, 16), n_ff=4, generator=cpu_gen())
    p = ZE.make_predict_fn(cpu, n_ff=4)(xc, cpu_gen()).numpy()
    gap = _metrics_gap(f"zoo harness {ZH_MC} n_ff=4", got, want, p, ZH_TOL)
    print(f"zoo harness {ZH_MC}: evaluate.test n_ff=4 (masks from one CPU "
          f"generator) card vs CPU max gap {gap:.2e}", flush=True)
    del card, cpu
    harness = read_counts()
    if any(harness.values()):
        fail(f"zoo harness: kernels of the port launched {harness}")

    # (b) the CLI's outputs, held to this process on the card
    res, secs = clis.result()
    behind.shutdown()
    paths = {"zoo_harness": harness}
    for (sub, _, label), (text, stats) in zip(runs, res):
        if stats["rc"] != 0:
            fail(f"cli.zoo {sub} {label} exited {stats['rc']}")
        _zero_launches(f"cli.zoo {sub} {label}", stats)
        agg = paths.setdefault(f"zoo_{sub}", {})
        for k, v in stats.items():
            if k not in ("rc", "secs", "peak_gib"):
                agg[k] = agg.get(k, 0) + v
    texts = {f"{sub} {label}": text for (sub, _, label), (text, _)
             in zip(runs, res)}
    torch.backends.cudnn.allow_tf32 = True  # the mode the CLI ran in
    try:
        _zoo_cli_held(x, y, root, seqs, model, second, texts, out, secs,
                      len(runs))
    finally:
        torch.backends.cudnn.allow_tf32 = False

    # (c) the harness's ms per batch against the forward's, over a seeded
    # stream the size of the CIFAR-10 test set, ZH_TIME_REPS passes each
    rng = np.random.default_rng(SEED + 2)
    xt = rng.standard_normal((ZH_TIME_ROWS, 32, 32, 3), dtype=np.float32)
    yt = rng.integers(0, 10, ZH_TIME_ROWS)
    nb = ZH_TIME_ROWS // ZH_BATCH
    for n, kw in ZH_MODELS:
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            timed = get_model(n, num_classes=10, image_size=32, dtype=dt,
                              device="cuda", **kw).eval()
            timed.load_state_dict(models[n].state_dict())
            ZE.test(timed, ZD.batches(xt[:2 * ZH_BATCH], yt[:2 * ZH_BATCH],
                                      ZH_BATCH))
            harness, fwd = [], []
            for _ in range(ZH_TIME_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ZE.test(timed, ZD.batches(xt, yt, ZH_BATCH))
                harness.append((time.perf_counter() - t0) * 1e3 / nb)
                fwd.append(measure_executive_time(
                    timed, size=(ZH_BATCH, 3, 32, 32), n=nb) * 1e3)
            h, f = float(np.median(harness)), float(np.median(fwd))
            line = (f"zoo harness {n} {dname}: evaluate.test over "
                    f"{ZH_TIME_ROWS} rows ({nb} batches of {ZH_BATCH}), "
                    f"{ZH_TIME_REPS} passes: median {h:.3f} ms per batch "
                    f"({min(harness):.3f}-{max(harness):.3f}; forward, "
                    f"softmax, copy to the host, numpy metrics); the "
                    f"forward alone median {f:.3f} ms ({min(fwd):.3f}-"
                    f"{max(fwd):.3f}), {f / h:.1%} of it; the rest "
                    f"{h - f:.3f} ms")
            if dname == "f32":
                # predtime's f32: the CLI keeps torch's cuDNN TF32 default
                torch.backends.cudnn.allow_tf32 = True
                try:
                    tf = measure_executive_time(
                        timed, size=(ZH_BATCH, 3, 32, 32), n=nb) * 1e3
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                line += (f"; the forward with cuDNN TF32 on {tf:.3f} ms "
                         f"({ZH_BATCH / tf * 1e3:.1f} img/s), off "
                         f"{ZH_BATCH / f * 1e3:.1f} img/s")
            print(line, flush=True)
    late = read_counts()
    if any(late.values()):
        fail(f"zoo harness timing: kernels of the port launched {late}")
    return paths


# 17c. The zoo trainer (`zoo.train`: schedules, the optax-semantics
# optimizers, ZooTrainer; `cli.zoo train`). No kernel of the port runs.
ZT_ROWS = 2560        # CIFAR-10 training rows in the pickles: 20 batches
ZT_BATCH = 128        # the global batch of every part
ZT_CHECK_STEPS = 3    # (a) steps of the card against the CPU
ZT_WARMUP, ZT_WINDOW, ZT_WINDOWS = 3, 20, 3  # (d) steps: warm-up, a window
ZT_PROFILE_STEPS = 1  # (d) steps under torch.profiler
ZT_MIXUP = {"mixup_alpha": 1.0, "cutmix_alpha": 0.8, "prob": 1.0}
# (a) and (d): ResNet-18 with SGD, weight decay and max_norm; ViT-Ti
# (4×4 patches) with AdamW, smoothing 0.1 and max_norm
ZT_MODELS = (
    ("resnet_dnn_18", {}, dict(optimizer_name="SGD", lr=0.01,
                               weight_decay=5e-4, max_norm=1.0)),
    ("vit_ti", {"patch_size": 4}, dict(optimizer_name="AdamW", lr=1e-3,
                                       weight_decay=0.05, smoothing=0.1,
                                       max_norm=1.0)))
# (a) the card against the CPU, f32 with TF32 off, the same weights and
# draws: each step's loss within 1e-4 relative; the parameters' change
# over the 3 steps, as one vector, within 5e-2 of its norm; each BN
# running statistic within 1e-3 of its tensor's largest entry. Two equal
# f32 steps of a BN ResNet in other orders differ far beyond rounding in
# some gradient entries (a ReLU input within rounding of 0 flips; the BN
# parameters' gradients are sums that cancel), and SGD carries that into
# the next steps; AdamW's first steps move every entry by about ±lr
# whatever its gradient's size, so where a gradient is rounding noise the
# two devices step apart by up to 2·lr.
ZT_LOSS_TOL, ZT_UPDATE_TOL, ZT_STATS_TOL = 1e-4, 5e-2, 1e-3
# (c) the data-parallel runs (ResNet-18, f32, TF32 off, one epoch of 20
# SGD steps at lr 0.005 clipped to a global norm of 1) against the
# one-process run: the parameters apart by at most ZT_DDP_TOL of the
# largest change the epoch can make (20 · lr · max_norm, in norm), the
# epoch's loss within 1e-4 relative, the running statistics within 1e-3
# of their tensor's largest entry. In f32 two equal steps on other row
# counts differ far beyond rounding in some gradient entries (a ReLU
# input within rounding of 0 flips; the BN parameters' gradients are
# sums that cancel), and SGD carries that into the next steps; a small
# lr keeps that drift well below the gap of a statistics' backward that
# does not sum over the ranks. The CPU tests hold the two paths to 1e-4
# in float64.
ZT_DDP_TOL, ZT_DDP_LOSS_TOL, ZT_DDP_STATS_TOL = 5e-2, 1e-4, 1e-3
ZT_DDP_LR, ZT_DDP_MAX_NORM = 0.005, 1.0
# The CLI processes of 17c: TF32 off, as in this process (their runs are
# held to each other in float32); started as two ranks, one gloo group on
# the one card (NCCL refuses two ranks on a device), which `cli.zoo train
# --data_axis 2` then joins; a single rank is left to the CLI, which
# starts NCCL.
_ZT_RUNNER = r'''
import os, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if int(os.environ.get("WORLD_SIZE", "1")) > 1:
    from dehaze_tpu_torch.parallel import dist as _dist
    _dist.init("cuda:0", "gloo")
''' + _RUNNER


def _zt_batches(root: str, n: int):
    """The first n global batches of the seeded CIFAR-10 training rows."""
    from dehaze_tpu_torch.zoo import data as ZD

    (x, y), _, _, _ = ZD.get_dataset("cifar10", root)
    b = ZT_BATCH
    return (x[:n * b].reshape(n, b, *x.shape[1:]),
            y[:n * b].reshape(n, b))


def _zt_model(name, kw, dtype, device):
    import torch

    from dehaze_tpu_torch.zoo import get_model

    torch.manual_seed(SEED)
    return get_model(name, num_classes=10, image_size=32, dtype=dtype,
                     device=device, **kw)


def _zt_trainer(model, recipe):
    from dehaze_tpu_torch.zoo.train import ZooTrainer

    tr = ZooTrainer(model, num_classes=10, mixup=ZT_MIXUP, seed=SEED,
                    steps_per_epoch=ZT_ROWS // ZT_BATCH, **recipe)
    tr.init()
    return tr


def _zt_card_vs_cpu(x, y, card_done=None):
    """(a) ZT_CHECK_STEPS steps of each of ZT_MODELS on the card and on
    the CPU from the same weights, with the same augment and mixup draws
    (the trainers' CPU generator, seeded alike), f32 with TF32 off. The
    card's steps run first; `card_done()`, when given, is called between
    them and the CPU's, which use CPU_REFERENCE_THREADS threads."""
    import numpy as np
    import torch

    runs = []
    for name, kw, recipe in ZT_MODELS:
        cpu = _zt_model(name, kw, torch.float32, "cpu")
        card = _zt_model(name, kw, torch.float32, "cuda")
        card.load_state_dict(cpu.state_dict())
        init = {k: v.detach().clone() for k, v in cpu.named_parameters()}
        tr = _zt_trainer(card, recipe)
        losses = [float(tr.train_step(x[i], y[i]))
                  for i in range(ZT_CHECK_STEPS)]
        runs.append((name, recipe, cpu, init, losses, {
            k: v.detach().cpu() for k, v in card.state_dict().items()}))
        del tr, card
    if card_done is not None:
        card_done()
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    try:
        for name, recipe, cpu, init, got_losses, got_sd in runs:
            tr = _zt_trainer(cpu, recipe)
            losses = [got_losses, [float(tr.train_step(x[i], y[i]))
                                   for i in range(ZT_CHECK_STEPS)]]
            ref = cpu.state_dict()
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(*losses))
            got = torch.cat([(got_sd[k] - init[k]).ravel() for k in init])
            want = torch.cat([(ref[k] - init[k]).ravel() for k in init])
            upd_gap = float((got - want).norm() / want.norm())
            stats_gap = max([float((v - ref[k]).abs().max()
                                   / ref[k].abs().max())
                             for k, v in got_sd.items() if "running" in k]
                            or [0.0])
            print(f"zoo train {name} ({recipe['optimizer_name']}, batch "
                  f"{ZT_BATCH}, augment and mixup on): card against CPU, "
                  f"f32, {ZT_CHECK_STEPS} steps: losses "
                  f"{[round(v, 6) for v in losses[0]]} (gap "
                  f"{loss_gap:.2e}), update {float(want.norm()):.4f} in "
                  f"norm, apart by {upd_gap:.2e} of it; running statistics "
                  f"{stats_gap:.2e} of their max", flush=True)
            if not (loss_gap <= ZT_LOSS_TOL and upd_gap <= ZT_UPDATE_TOL
                    and stats_gap <= ZT_STATS_TOL
                    and np.isfinite(losses).all()):
                fail(f"zoo train {name}: card against CPU, tolerances: "
                     f"loss {ZT_LOSS_TOL}, update {ZT_UPDATE_TOL}, running "
                     f"statistics {ZT_STATS_TOL}")
    finally:
        torch.set_num_threads(threads)


def _zt_times(x, y, card: str):
    """(d) ms per training step at batch ZT_BATCH of each of ZT_MODELS in
    bf16 and f32 (TF32 off): CUDA events over ZT_WINDOWS windows of
    ZT_WINDOW steps after ZT_WARMUP, the median and the spread; the host's
    ms to queue a step; peak memory; the calls in a step that make the
    host wait for the card; a profile of ZT_PROFILE_STEPS steps (device
    time, idle share, kernel groups)."""
    import warnings

    import numpy as np
    import torch

    for name, kw, recipe in ZT_MODELS:
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            tr = _zt_trainer(_zt_model(name, kw, dt, "cuda"), recipe)
            it = iter(range(1 << 30))

            def step():
                i = next(it) % len(x)
                tr.train_step(x[i], y[i])

            for _ in range(ZT_WARMUP):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, host = [], []
            for _ in range(ZT_WINDOWS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                for _ in range(ZT_WINDOW):
                    step()
                host.append((time.perf_counter() - t0) / ZT_WINDOW * 1e3)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1) / ZT_WINDOW)
            med = float(np.median(ms))
            peak = torch.cuda.max_memory_allocated() / 2**30
            # the calls in a step that make the host wait for the card
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({f"{os.path.relpath(w.filename, REPO)}:"
                            f"{w.lineno}" for w in caught
                            if "prototype" not in str(w.message)})
            print(f"zoo train step {name} {dname} ({card}): batch "
                  f"{ZT_BATCH} at 32², {ZT_WINDOWS} windows of {ZT_WINDOW} "
                  f"steps: median {med:.3f} ms ({min(ms):.3f}-"
                  f"{max(ms):.3f}), {ZT_BATCH / med * 1e3:.1f} img/s; the "
                  f"host {float(np.median(host)):.3f} ms to queue a step; "
                  f"peak {peak:.2f} GiB; host waits for the card in a "
                  f"step: {len(syncs)} {syncs[:6]}", flush=True)
            prof = _profile(f"zoo train step {name} {dname}", step,
                            ZT_PROFILE_STEPS, med)
            if prof is None:
                print("  (no device time: idle share not measured)",
                      flush=True)


def phase_zoo_train(tmp: str, card: str):
    """17c. The zoo trainer, on phase 17b's seeded CIFAR-10 pickles
    (ZT_ROWS training rows): (a) ZT_MODELS on the card against the CPU
    (_zt_card_vs_cpu); (b) `cli.zoo train` in a subprocess, ViT-Ti (4×4)
    in bf16, AdamW with the cosine schedule, 1 warmup epoch and 1 epoch,
    mixup, smoothing 0.1, --max_norm 1: its `.pth.tar` files, and `cli.zoo
    eval --ckpt best.pth.tar` giving the accuracy its train run printed
    for that epoch; (c) ResNet-18 f32 SGD, one epoch with augment and
    mixup, with --data_axis 2 as two gloo ranks on the card and with
    --data_axis 1 as one NCCL rank, each held to the one-process run of
    the same flags; (d) the step times (_zt_times). (c)'s processes run
    beside (a); the one-process run shares a process with (b), whose runs
    wait until the ranks have ended and (a) has left the card for its CPU
    half (on CPU_REFERENCE_THREADS of the host's cores), so that its
    epochs' img/s see an idle card; (d) last, alone. K1, K2 and K3 launch
    0 times on every path. Returns the launch counts of (a) and (d)
    (`zoo_train`), of the CLI process's three runs (`zoo_train_cli`) and
    of (c)'s ranks (`zoo_train_ddp`)."""
    import re

    import torch

    root = os.path.join(tmp, "zoo_data")
    if not os.path.isdir(root):
        fail(f"phase 17c needs phase 17b's pickles under {root}")
    out = {k: os.path.join(tmp, f"zoo_train_{k}") for k in
           ("vit", "one", "gloo", "nccl")}
    resnet = ["--name", "resnet_dnn_18", "--dataset", "cifar10", "--root",
              root, "--batch_size", ZT_BATCH, "--optimizer", "SGD", "--lr",
              ZT_DDP_LR, "--max_norm", ZT_DDP_MAX_NORM, "--weight_decay",
              5e-4, "--mixup", "--seed", SEED]
    vit = ["--name", "vit_ti", "--patch_size", 4, "--image_size", 32,
           "--dataset", "cifar10", "--root", root, "--batch_size",
           ZT_BATCH, "--bf16"]

    def ranks(n, extra, label):
        spec = json.dumps([["zoo", [str(a) for a in ["train"] + resnet
                                    + extra]]])
        return _ranks(["-c", _ZT_RUNNER, spec], n, label)

    t0 = time.perf_counter()
    reset_counts()
    # one process runs (c)'s one-process ResNet-18 run at once, beside
    # (a) and the ranks, then waits for `go` before (b)'s runs: so (b)
    # starts warm (imports, CUDA context, torch's lazy modules) and its
    # epochs see an idle card
    go = os.path.join(tmp, "zoo_train_go")
    loop = "for i, (cli, args) in enumerate(json.loads(sys.argv[1])):\n"
    waiting = _ZT_RUNNER.replace(loop, loop + (
        "    if i == 1:\n"
        f"        while not os.path.exists({go!r}):\n"
        "            time.sleep(0.05)\n"), 1)
    with cf.ThreadPoolExecutor(4) as behind:
        gloo = behind.submit(ranks, 2, ["--data_axis", 2, "--device",
                                        "cuda:0", "--out", out["gloo"]],
                             "cli.zoo train --data_axis 2 (gloo)")
        nccl = behind.submit(ranks, 1, ["--data_axis", 1, "--out",
                                        out["nccl"]],
                             "cli.zoo train --data_axis 1 (NCCL)")
        clis = behind.submit(_counted_clis, [
            ("zoo", ["train"] + resnet + ["--out", out["one"]],
             "train resnet_dnn_18 f32"),
            ("zoo", ["train"] + vit + [
                "--optimizer", "AdamW", "--lr", 1e-3, "--weight_decay",
                0.05, "--warmup_epochs", 1, "--epochs", 1, "--mixup",
                "--smoothing", 0.1, "--max_norm", 1, "--seed", SEED,
                "--out", out["vit"]], "train vit_ti bf16"),
            ("zoo", ["eval"] + vit + ["--ckpt", os.path.join(
                out["vit"], "best.pth.tar")], "eval best.pth.tar")],
            script=waiting)
        started = []

        def start_b():
            """(b) goes once the ranks have ended and (a) has left the
            card."""
            cf.wait([gloo, nccl])
            started.append(time.perf_counter())
            with open(go, "w"):
                pass

        try:
            x, y = _zt_batches(root, ZT_CHECK_STEPS)
            _zt_card_vs_cpu(x, y, lambda: behind.submit(start_b))
            ta = time.perf_counter()
            gloo, nccl = gloo.result(), nccl.result()
        finally:  # (b)'s runs wait for it, whatever failed here
            if not os.path.exists(go):
                with open(go, "w"):
                    pass
        res, _ = clis.result()
        t1 = started[0] if started else ta
    t2 = time.perf_counter()
    x, y = _zt_batches(root, ZT_ROWS // ZT_BATCH)
    _zt_times(x, y, card)
    print(f"phase 17c parts: (a) {ta - t0:.1f} s and the ranks of (c) "
          f"{t1 - t0:.1f} s beside each other, then (b) {t2 - t1:.1f} s "
          f"(beside the rest of (a)'s CPU steps), (d) "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    paths = {"zoo_train": read_counts(), "zoo_train_cli": {},
             "zoo_train_ddp": {}}
    _zero_launches("zoo train (in process)", paths["zoo_train"])

    # (b) the CLI's files and the accuracy of its best checkpoint
    for (text, stats), label in zip(res, ("train resnet_dnn_18",
                                          "train vit_ti", "eval")):
        if stats["rc"] != 0:
            fail(f"cli.zoo {label} exited {stats['rc']}")
        _zero_launches(f"cli.zoo {label}", stats)
        for k, v in stats.items():
            if k not in ("rc", "secs", "peak_gib"):
                agg = paths["zoo_train_cli"]
                agg[k] = agg.get(k, 0) + v
    train_text, eval_text = res[1][0], res[2][0]
    files = sorted(os.listdir(out["vit"]))
    if files != ["best.pth.tar", "epoch_0.pth.tar", "epoch_1.pth.tar"]:
        fail(f"cli.zoo train wrote {files}")
    best = float(re.findall(r"^best acc: (\S+)$", train_text, re.M)[0])
    evald = float(re.findall(r"Accs: (\S+) %", eval_text)[0]) / 100
    if abs(best - evald) > 5e-5:
        fail(f"cli.zoo eval --ckpt best.pth.tar: acc {evald:.5f}, the "
             f"train run printed best acc {best:.4f}")
    ips = [float(v) for v in re.findall(r"^  train: \S+ s, (\S+) img/s",
                                        train_text, re.M)]
    epochs = re.findall(r"^((?:Warmup e|E)poch: .*)$", train_text, re.M)
    vit_stats, eval_stats = res[1][1], res[2][1]
    print(f"cli.zoo train vit_ti bf16 ({vit_stats['secs']:.1f} s, then "
          f"eval {eval_stats['secs']:.1f} s): {' | '.join(epochs)}; img/s "
          f"per epoch {ips} ({ZT_ROWS // ZT_BATCH} steps of {ZT_BATCH}); "
          f"peak {vit_stats['peak_gib']:.2f} GiB; best acc {best:.4f}, "
          f"`eval --ckpt best.pth.tar` {evald:.4f}", flush=True)

    # (c) the data-parallel runs against the one-process run
    want = torch.load(os.path.join(out["one"], "epoch_0.pth.tar"),
                      weights_only=True)["state_dict"]
    for label, outs, path in (("--data_axis 2 (2 gloo ranks)", gloo,
                               out["gloo"]),
                              ("--data_axis 1 (1 NCCL rank)", [nccl[0]],
                               out["nccl"])):
        for r, text in enumerate(outs):
            (_, stats), = _split_runs(text)
            if stats["rc"] != 0:
                fail(f"cli.zoo train {label} rank {r} exited {stats['rc']}")
            _zero_launches(f"cli.zoo train {label} rank {r}", stats)
            for k, v in stats.items():
                if k not in ("rc", "secs", "peak_gib"):
                    agg = paths["zoo_train_ddp"]
                    agg[k] = agg.get(k, 0) + v
        got = torch.load(os.path.join(path, "epoch_0.pth.tar"),
                         weights_only=True)["state_dict"]
        reach = ZT_ROWS // ZT_BATCH * ZT_DDP_LR * ZT_DDP_MAX_NORM
        par = float(torch.cat([(got[k] - v).ravel() for k, v in want.items()
                               if v.is_floating_point()
                               and "running" not in k]).norm()) / reach
        stat = max(float((got[k] - v).abs().max() / v.abs().max())
                   for k, v in want.items() if "running" in k)
        loss = [float(re.findall(r"^Epoch: 0, Loss: (\S+),", t, re.M)[0])
                for t in (outs[0], res[0][0])]
        loss_gap = abs(loss[0] - loss[1]) / loss[1]
        print(f"cli.zoo train resnet_dnn_18 {label}: epoch loss {loss[0]} "
              f"(one process {loss[1]}); parameters apart by {par:.2e} of "
              f"the epoch's reach ({reach:.2f} in norm), running "
              f"statistics {stat:.2e} of their max; 0 launches of every "
              "kernel", flush=True)
        if not (par <= ZT_DDP_TOL and loss_gap <= ZT_DDP_LOSS_TOL
                and stat <= ZT_DDP_STATS_TOL):
            fail(f"cli.zoo train {label} against the one-process run: "
                 f"parameters {par:.2e} (tolerance {ZT_DDP_TOL}), loss "
                 f"{loss_gap:.2e} ({ZT_DDP_LOSS_TOL}), running statistics "
                 f"{stat:.2e} ({ZT_DDP_STATS_TOL})")
    return paths


def main() -> None:
    sys.path.insert(0, REPO)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not os.path.isdir(os.path.join(REPO, "dehaze_tpu_torch")):
        fail("dehaze_tpu_torch/ not found beside chip_smoke.py")
    t_start = time.perf_counter()

    def timed(phase, *args):
        """phase(*args), then its seconds on a line of their own."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"phase {phase.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    card = timed(phase_device)
    # the plain twins compute in float32 where the kernels do: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp, \
            cf.ThreadPoolExecutor(2) as behind:
        # nvcc builds the kernels on the host while the data is written
        # and FFA-Net and the UNet, which need no kernel of the port, run
        # on the card: their frames (timed by CUDA events), then their
        # entry points, done before any kernel is timed
        build = behind.submit(timed, phase_build)
        timed(phase_data, tmp)
        ffa_frames, _ = timed(phase_ffa_frames, tmp)
        ffa_runs = behind.submit(timed, phase_ffa_runs, tmp)
        build.result()
        ffa_runs = ffa_runs.result()
        timed(phase_codec)
        k1_res = timed(phase_k1)
        k1p_res = timed(phase_k1_pad)
        k1b_res = timed(phase_k1_bwd)
        k3_res = timed(phase_k3)
        k2_res = timed(phase_k2)
        pth = timed(phase_model, tmp)
        timed(phase_model_pad, pth)
        frame_f32 = timed(phase_frame_f32, pth)
        serve = timed(phase_serve, pth)
        evals, eval_psnrs = timed(phase_eval, tmp, pth)
        act_res, act_paths = timed(phase_k2_actstore, tmp, pth)
        timed(phase_k2_trips)
        gate = timed(phase_parity_gate, tmp, pth)
        serving = timed(phase_serving, tmp, pth, eval_psnrs)
        timed(phase_train_parity)
        train, stream_epoch, _ = timed(phase_train_cli, tmp)
        analysis = timed(phase_analysis, tmp, pth)
        device_data = timed(phase_device_data, tmp, stream_epoch)
        remat = timed(phase_remat, tmp)
        timed(phase_train_profile, tmp)
        wmsa = timed(phase_wmsa, tmp)
        multi = timed(phase_multi, tmp, pth, eval_psnrs)
        ffa = {**ffa_frames, **timed(phase_ffa, tmp, ffa_runs)}
        zoo = timed(phase_zoo, tmp)
        zoo_harness = timed(phase_zoo_harness, tmp)
        zoo_train = timed(phase_zoo_train, tmp, card)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, source, replaces, res, main, key, paths):
        row = next(r for r in res if r[:len(main)] == main)
        res = [r for r in res if r[1] == "bfloat16"] or res
        launches = {p: c.get(key, 0) for p, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(r[-5] for r in res),
                "ms": row[-4], "plain_ms": row[-3], "bound_ms": row[-2],
                "bound_by": row[-1], "library_ms": None}

    paths = {"serve": serve, "train": train, "eval": evals,
             "parity_gate": gate, **serving,
             "train_device_data": device_data, "train_step_remat": remat,
             **analysis, **wmsa, **multi, **ffa, **zoo, **zoo_harness,
             **zoo_train}
    wa = "dehaze_tpu_torch/csrc/window_attention.cu"
    pw = "dehaze_tpu/ops/pallas/window_attention.py"
    # the float32 frame: the path of the float32 kernels
    f32_paths = {"frame_f32": frame_f32}
    # K1 rows by kernel, without the kernel column
    k1_all = k1_res + k1p_res
    tc = [r[:2] + r[3:] for r in k1_all if r[2] == "tc"]
    f32 = [r[:2] + r[3:] for r in k1_all if r[2] == "f32"]
    cc = [r[:2] + r[3:] for r in k1_all if r[2] == "cuda_core"]
    bwd_all = k1b_res + [r[:2] + (r[2][:-4],) + r[3:] for r in k1p_res
                         if r[2].endswith("_bwd")]
    tc_bwd = [r[:2] + r[3:] for r in bwd_all if r[2] == "tc"]
    cc_bwd = [r[:2] + r[3:] for r in bwd_all if r[2] == "cuda_core"]

    def k3_of(key, kern):  # K3 rows of one kernel, without its column
        return [r[:2] + r[3:] for r in k3_res[key] if r[2] == kern]

    kernels = {"kernels": [
        entry("K1 ProbSparse window attention fwd, tensor cores (bf16, "
              "N <= 64)", "dehaze_tpu_torch/csrc/window_attention_tc.cu",
              f"{pw}:912", tc, ("enc0", "bfloat16"), "k1_fwd_tc", paths),
        entry("K1 ProbSparse window attention fwd, float32 (N <= 64, head "
              "dims 16-64; CUDA cores, register-blocked)", wa, f"{pw}:912",
              f32, ("enc0", "float32"), "k1_fwd_f32", f32_paths),
        entry("K1 ProbSparse window attention fwd, CUDA cores (N > 64, "
              "other head dims)", wa, f"{pw}:912", cc,
              ("N256", "bfloat16"), "k1_fwd", paths),
        entry("K1 ProbSparse window attention bwd, tensor cores (bf16, "
              "N <= 64)", "dehaze_tpu_torch/csrc/window_attention_tc.cu",
              f"{pw}:938", tc_bwd, ("enc0", "bfloat16"), "k1_bwd_tc", paths),
        entry("K1 ProbSparse window attention bwd, CUDA cores (f32, "
              "N > 64, other head dims)", wa, f"{pw}:938", cc_bwd,
              ("N256", "bfloat16"), "k1_bwd", paths),
        *(dict(entry(f"K2 fused LayerNorm+LeFF, {what}",
                     "dehaze_tpu_torch/csrc/leff.cu",
                     "dehaze_tpu/ops/pallas/leff.py:120",
                     [r for r in k2_res if r[1] == dname],
                     ("enc0", dname, "erf"), "k2", where),
               cases=[dict(zip(("case", "dtype", "gelu", "max_abs_err", "ms",
                                "plain_ms", "bound_ms", "bound_by"), r))
                      for r in k2_res if r[1] == dname])
          for what, dname, where in (
              ("bf16 (tensor cores)", "bfloat16", paths),
              ("float32 (3xTF32 tensor cores)", "float32", f32_paths))),
        *(dict(entry(f"K2 fused LayerNorm+LeFF with --act_store {mode} "
                     "(the round trips inside the kernel)",
                     "dehaze_tpu_torch/csrc/leff.cu",
                     "dehaze_tpu/ops/pallas/leff.py:120",
                     [r[:2] + r[3:] for r in act_res if r[2] == mode],
                     ("enc0", "bfloat16"), "k2", act_paths[mode]),
               cases=[dict(zip(("case", "dtype", "share_beyond_k2_tol",
                                "own_steps_beyond", "top_steps_beyond",
                                "max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by"),
                               r[:2] + r[3:]))
                      for r in act_res if r[2] == mode])
          for mode in ("fp8", "int8")),
        entry("K3-v1 ProbSparse window attention fwd, [B,H,N,D], tensor "
              "cores (bf16)", "dehaze_tpu_torch/csrc/window_attention_tc.cu",
              f"{pw}:317", k3_of("v1", "tc"), ("enc1", "bfloat16"),
              "k3_v1_tc", paths),
        entry("K3-v1 ProbSparse window attention fwd, [B,H,N,D], CUDA "
              "cores (f32)", wa, f"{pw}:317", k3_of("v1", "cuda_core"),
              ("enc1", "float32"), "k3_v1", paths),
        entry("K3-v2 ProbSparse window attention fwd, [B,H,N,D], tensor "
              "cores (bf16)", "dehaze_tpu_torch/csrc/window_attention_tc.cu",
              f"{pw}:220", k3_of("v2", "tc"), ("enc1", "bfloat16"),
              "k3_v2_tc", paths),
        entry("K3-v2 ProbSparse window attention fwd, [B,H,N,D], CUDA "
              "cores (f32)", wa, f"{pw}:220", k3_of("v2", "cuda_core"),
              ("enc1", "float32"), "k3_v2", paths),
        entry("K3-v3 ProbSparse window attention fwd, tensor cores (bf16)",
              "dehaze_tpu_torch/csrc/window_attention_tc.cu", f"{pw}:618",
              k3_of("v3_fwd", "tc"), ("train_enc0", "bfloat16"),
              "k3_v3_fwd_tc", paths),
        entry("K3-v3 ProbSparse window attention fwd, CUDA cores (f32)", wa,
              f"{pw}:618", k3_of("v3_fwd", "cuda_core"),
              ("train_enc0", "float32"), "k3_v3_fwd", paths),
        entry("K3-v3 ProbSparse window attention bwd, tensor cores (bf16)",
              "dehaze_tpu_torch/csrc/window_attention_tc.cu", f"{pw}:639",
              k3_of("v3_bwd", "tc"), ("train_enc0", "bfloat16"),
              "k3_v3_bwd_tc", paths),
        entry("K3-v3 ProbSparse window attention bwd, CUDA cores (f32)", wa,
              f"{pw}:639", k3_of("v3_bwd", "cuda_core"),
              ("train_enc0", "float32"), "k3_v3_bwd", paths),
    ]}
    print(f"card: {card}", flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
