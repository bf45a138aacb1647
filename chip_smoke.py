#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubresnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi); no card,
             no run: without CUDA the script exits 1 before anything.
2. build   — nvcc builds the thirteen Hopper kernels from
             ubresnet_tpu_torch/ops/csrc for sm_90a (-Xptxas -v): every
             kernel's registers, spills and static shared memory; beside
             it g++ builds the host libraries librootio and libuevt from
             ubresnet_tpu_torch/cpp (compiler, seconds).
3. kernels — every kernel-zone layer of the flagship UResNet at its
             main-path shape and batch (16): the kernel against its plain
             PyTorch version on the same bf16 inputs, the kernel's, the
             plain version's and the library call's time (CUDA events),
             and the bound from the bytes and operations. Eval rows (K1-K4,
             max abs error ≤ 1e-2·max|plain| for K1-K3 — one bf16 rounding
             of the output —, exact for K4), int8 rows (K1-s8 head, K2-s8
             ×6, K3-s8 ×2 on int8 inputs: the float32 output bit-identical
             to the plain version's — exact s32 sums, with g = 1, b = 0
             for the conv and deconv the accumulator itself —, the bf16
             output within one bf16 step; bound from the int8 tensor-core
             rate; library_ms null — no PyTorch call computes an int8
             conv — with the same layer's bf16 kernel and cuDNN bf16
             times beside it) and train rows: K5 (y as K1;
             its f32 sums of the bf16 y ≤ 1e-3·max|plain|, where one bf16
             step of some y may differ), K1 as the input gradient (as K1),
             K6 (f32 dW ≤ 1e-3·max|plain|: sums over 1-4 M pixels in
             another order; the same bits on a second launch; its ms and
             cuDNN's the median of 5 passes, min and max beside; its
             launch geometry and cross-cluster scratch bytes), K7
             forward and backward (f32, ≤ 1e-5·max);
             deconv-AD rows at dec2's and dec1's b16 shapes: K10 (dx as
             K1 and dW as K9 from one launch, against deconv2x_bwd_plain;
             library: torch.autograd.grad of F.conv_transpose2d, cuDNN
             bf16), K8 (dx, as K1) and K9 (f32 dW ≤ 1e-3·max|plain|, as
             K6; its and the plain version's distance from a float64 dW
             reported) alone, and deconv2x_ad forward + backward (K3,
             K10) against F.conv_transpose2d's f32 autograd (y, dx and
             the bf16 dW each ≤ 1e-2·max|plain|), with the host µs a call
             (wall time of back-to-back calls) beside its kernels' time.
             Each row also gives pct_of_bound (bound_ms / ms) and
             vs_library (ms / library_ms); K1, K5, K6, K8, K9, K10 and
             the int8 rows also the ptxas registers, spills and stack of
             the kernel instance they launch, and K5, K6, K8, K9 and K10
             rows launch twice and require the same bits (same_bits). K1, K2,
             K3, K5, K6, K8, K9 and K10 are bf16 tensor-core kernels (mma.sync
             m16n8k16, f32 accumulators), K1-s8, K2-s8 and K3-s8 int8
             ones (m16n8k32, exact s32 accumulators: K1-s8 runs K1's
             mainloop with two 7x7 taps a 32-deep k-step, K2-s8 and
             K3-s8 carry K2's and K3's designs), each in a persistent
             grid: each block walks its tiles, the next tile's input
             arriving by double-buffered cp.async (K6: a 3-4 stage
             ring); all but K4, K6, K7
             and K9 stage their layer's weights in shared memory once
             per block, K2 and K2-s8 keep m (with its halo) on chip, K3
             and K3-s8 compute all four output parity classes of a tile
             from one read of its input, K5 is K1's mainloop with the
             sums of its bf16 y kept per lane and reduced per block in a
             fixed order, K8, K9 and K10
             read each haloed dy tile as its four parity planes (each
             tap one plane at stride 1), K6, K9 and K10 keep their block's
             share of dW in registers (K6: x_rowᵀ·dy_row per x row and
             tap row, wgmma at the 3x3s with ci 64 and the 7x7s with co
             16; K9: x_tileᵀ·dy_tap per tap, by ldmatrix.trans); K6
             adds its blocks' dW through clusters of 2 and sum_rows, K10
             in the same launch through clusters of 8; K10 runs K8's
             and K9's GEMMs on one read of x and dy.
             The eval and int8 rows again at the wholeview paths' cells:
             b10 512x832 (one stitched chunk of crops) and b1 1024x3456
             (the spatial path's padded plane), under the same checks.
             The reference's other two UResNets (the widths phase): the
             inplanes-32 zone where JAX fuses it (K4 at C = 32, K2 ×6 —
             (32, 0, 64) resident, (64, 0, 64) and the dual (64, 64, 64)
             in the streamed form —, K3 (64, 32), the classifier) bf16
             and int8 at b16 512², the streamed blocks again at the
             wholeview cells, its train zone (K5, K1 dx, K6 at its seven
             shapes) on b16 256² crops; the 4-class classifier (16, 4,
             7), its dx and dW legs and K7 at C = 4; the inplanes-32
             trainer's dec1 (64, 32) deconv-AD rows (K10, K8, K9,
             deconv2x_ad) and its classifier at 256². The 8-channel
             streams (the widths_8 phase): the zones of inplanes 8 and
             4 bf16 and int8 at b16 512² (K2 at (8, 0, 16), (8, 8, 8),
             (8, 0, 8); K3 at (16, 8), (8, 4); K1 at the head (8, 16, 7)
             and the per-conv blocks' (8, 8, 3), (8, 4, 3), (8, 4, 1);
             the same on K2-s8, K3-s8, K1-s8), their train zones (K5,
             K1 dx, K6) and deconv-AD rows (K10, K8, K9 at (32, 16),
             (16, 8), (8, 4)). Their rows name their cell ("inplanes 32", "4
             classes", "inplanes 8", "inplanes 4"); K2 rows give their
             form (resident or streamed) beside their ptxas figures.
4. main    — 64 synthetic 512x512 crops scored file → file through the
             port's CLI (-b 16, cuda) with seeded random weights in a
             reference-format .tar; every event must carry 3 score
             images summing to 1 ± 1e-2, every kernel must have run its
             11-launches-per-batch share, and the kernel path must
             agree with the plain f32 path (TF32 off) on the argmax of
             the 16 crops of the timed forward for ≥ 99% of pixels.
             Also forward-only crops/s, the stage breakdown and a
             torch.profiler view of the b16 forward (device busy and idle
             shares, largest kernels), and a second, warm CLI run.
5. train_parity — one seeded 512² batch of 16, the same weights: the
             train kernel path (bf16), the plain path (bf16, fused_train
             off) and the f32 plain path (TF32 off): loss and every
             parameter gradient. Gates: the kernel path is no further
             from the f32 path than twice the plain bf16 path is (loss
             and max|Δgrad|/max|grad|, with floors 1e-3 and 1e-2). Then
             5 Adam steps (lr 1e-3) on the batch: the loss must fall;
             steps 2-5 timed with CUDA events. A torch.profiler trace
             of 2 more steps gives the zone kernels' device time per
             step, the busy and idle shares and the largest other
             kernels (reported, not gated).
   train_deconv — the same batch and weights through the train step
             with Policy.fused_train_deconv (K3 forward, K10 dx and dW at
             dec2 and dec1): loss and gradients under the same gates
             against the same plain paths, then 5 Adam steps whose
             launches are exactly 5 × (K5 16, K1 18, K6 17, K4 1, K7
             1 + 1, K3 2, K10 2; no K8 or K9); the loss must fall. Step
             ms beside the default zone's, the profiler's K3/K10 device
             time per step, and deconv2x_ad forward + backward against
             cuDNN's from the kernel rows (reported).
6. train   — the port's training CLI (--device cuda) on 64 synthetic
             512² events: batch 16, 8 iterations, validation every 4
             (1 batch), checkpoints every 4, the default sparse
             transfer. Gates: no error, final_iter 8, a finite loss at
             every iteration, launch counts = the per-step table × 8
             (K5 16, K1 18, K6 17, K4 1, K7 1 + 1) + 11 per validation
             forward, and the final .tar scores a crop through the eval
             model with probability sums 1 ± 1e-2.
   qat     — the training CLI with --set model.qat=true on the same
             64 events: 4 iterations, one validation (fake-quantized,
             per-conv blocks: no K2); launches exactly 4 × the step table
             + K4 1, K3 2, K1 2; finite losses; the final .tar scores a
             crop with probability sums 1 ± 1e-2. Then the int8 ladder
             (python -m ubresnet_tpu_torch.tools.int8_ladder 10, 512²,
             batch 32): its JSON, reported, not gated.
7. int8    — the deploy smoke's 64 crops through the CLI with --int8
             (calibrated on the first 32, -b 16, cuda): launch counts
             exactly K1-s8 1, K2-s8 6, K3-s8 2, K4 1, K1 1 per batch,
             score sums 1 ± 1e-2; on one b16 batch the int8 kernel path
             against the int8 plain path with the same scales (argmax
             ≥ 0.99), int8 vs bf16 forward ms and their ratio, the int8
             stage breakdown,
             and (not gated: random weights) mean|Δp| and argmax
             agreement against the f32 path for abs-max and
             percentile-99.9 scales.
8. wholeview — 4 synthetic whole planes (1008x3456, seed 0) through
             python -m ubresnet_tpu_torch.cli.infer_wholeview --device
             cuda: spatial (the default: first, warm, --f16-scores),
             --stitched and --int8 --int8-calib 2. Gates: 3
             ubsnet_plane2 images of 1008x3456 per event summing to
             1 ± 1e-2; launches exactly 11 per plane (spatial), 11 per
             10-crop chunk (stitched, one chunk a plane), the int8
             table per plane;
             on one plane the kernel path against the f32 plain path
             (TF32 off), spatial and stitched, and the int8 kernel path
             against the int8 plain path on the same scales, argmax
             ≥ 0.99. Reported: planes/s, the timing dicts, forward ms
             per plane, the spatial forward's stages and profile, peak
             memory.
9. serve   — python -m ubresnet_tpu_torch.cli.serve --once --device
             cuda over two precropped files of 16 crops and a corrupt
             file (-b 16), then over one whole-plane file of 2 events
             (--wholeview). Gates: the good files served (score sums
             1 ± 1e-2), the corrupt one quarantined (.failed), the
             shutdown line, launches exactly 11 per batch and per plane.
10. root   — larcv .root in and out on the card, at the main path's
             sizes and weights: each codec of librootio linked, dlopen'ed
             or absent, and the build phase's host build; the main
             phase's 64 crops, the wholeview phase's 4 planes and the
             train phase's 64 events .uevt → .root with uevt_to_root,
             read back equal (pixels, meta, run/subrun/event);
             infer_precropped .root → .root (-b 16; first and warm) and
             infer_wholeview .root → .root (spatial; the wire producer),
             each beside its .uevt → .uevt run: 3 float32 score images
             an event summing to 1 ± 1e-2, launches exact (11 a batch or
             a plane), argmax agreement with the .uevt scores ≥ 99.9% and
             max|Δp| ≤ 1e-2 (bit equality printed); serve --once
             --root-out over a .root, a .uevt and a corrupt .root (both
             served to <name>_scores.root, the corrupt one quarantined,
             launches exact); the train CLI on the .root (batch 16, 8
             iterations, native: true) plain, with --set model.remat=true
             and with --set remat=true: the NativeBatchLoader served,
             finite losses, launches exactly the step table × 8 plus, per
             step, K5 15 (stage remat) or K5 16, K4 1, K1 1 (whole
             forward); 2 iterations under --trace (the trace names a zone
             kernel) and --debug-dump (48 PNGs). On train_parity's batch
             one Adam step without remat, with stage remat and with
             whole-forward remat: each remat step's loss and gradients
             within train_parity's gates of the no-remat step's, its BN
             running stats within 1e-6·max|stat| of them, its launches
             exactly the step table plus the remat launches above; step
             ms (CUDA events) and peak memory of each.
11. aspp   — ASPP-ResNet (inplanes 16, branches 16, seeded random
             weights in a reference .tar) at full width and depth: the
             main phase's 64 crops through infer_precropped --arch
             aspp_resnet -b 16 (first, warm) and with the default --arch
             (the same bytes); 11 launches a batch, score sums 1 ± 1e-2,
             argmax ≥ 99% against the f32 path on the timed b16 batch;
             forward-only b16 ms and crops/s, the stage breakdown (aspp3-5,
             their recompressions, dec5, dec4 named); --int8 (calibrated
             on 32): the int8 table per batch, mean|Δp| from f32
             reported; 2 whole 1008x3456 planes through infer_wholeview
             --arch aspp_resnet: 11 launches a plane, argmax against f32 on
             one plane ≥ 99%, forward ms per plane; train_parity's batch
             under its gates, 5 Adam steps (loss falls, exactly the step
             table's launches), step ms and crops/s; the train CLI with
             --set model.name=aspp_resnet, 4 iterations and one
             validation: the step table x 4 + 11 launches.
12. distributed — the multi-process layer at the flagship width on the
             train smoke's 64 events (batch 16 a process): python -m
             ubresnet_tpu_torch.cli.launch --distributed 1 (NCCL), 8
             iterations: its log names the NCCL backend and cuda:0, its
             losses (the JSONL log) equal the plain train CLI's on the
             same config within 1e-6 relative, its launches the step
             table x 8; two ranks spawned on the one card (gloo), each
             taking half of train_parity's b16 batch, one Adam step,
             against one process taking it whole: loss, accuracies,
             gradients, BN running stats and the updated parameters
             each within 4x this run's spread of reduction order alone
             (one process on the batch reordered two ways), and within
             train_parity's loss and gradient gates and twice the
             zone-vs-plain BN stats distance; the replicas bit-equal,
             each rank's launches the step table; a negative control,
             two ranks with per-rank BN moments, must exceed the BN
             stats and loss bounds; one NCCL rank (the one-rank
             timings);
             launch --sweep of two 4-iteration jobs at --parallel 2 on a
             tree whose kernel stamp was removed (one build, under the
             lock, restores it), one job with fault_at_iter=2 and
             --retries 1: both exit 0, the faulted one logs its restart
             and "resumed from iter 2", both end at step 4;
             infer_precropped --data-parallel -b 16 on the main phase's
             64 crops: the main phase's bytes, 11 launches a batch.
             Reported, not gated: step ms (CUDA events) of one process,
             one NCCL rank and two gloo ranks sharing the card, the
             gradient all-reduce's ms and the BN collectives' total per
             step under gloo and NCCL, the phase's seconds; the card
             line again.
13. golden  — the 2018-paper Caffe parity stack at the oracle shape
             (512², the ssnet2018 graph at inplanes 16): golden_parity's
             three surrogate caffemodels (sha256 each, draw + write
             seconds; one parsed and written again, the same bytes, each
             step timed); python -m ubresnet_tpu_torch.cli.infer_caffe
             --device cuda over a 2-event three-plane file (3
             ssnet_plane%d float32 images of 512x512 per plane per event
             summing to 1 ± 1e-5, no port kernel launched); on one crop
             the f32 oracle (TF32 off) against the same net in float64 on
             the card, label agreement ≥ 0.999 over ADC > 10 and softmax
             max|Δp| ≤ 1e-4, which the same net with TF32 let in must
             exceed; the b1 forward's ms (CUDA events) and profile;
             golden_parity --dry-run --device cuda -n 16: exit 0, every
             plane ≥ 0.999, the negative control detected (its margin in
             pixels reported), each caffe leg's timing; official mode with the three surrogates and a
             tame reference .tar (the classifier x 3e-5): the exit code
             0 if the report is ok else 1, every plane with pixels over
             threshold, launches exactly 11 a plane (one batch each of
             the port's infer_precropped); agreement reported (two
             unrelated random networks).
14. widths  — the reference's other two UResNets, every layer routed as
             the JAX package routes it (models/blocks.py routes), seeded
             random weights: inplanes 32 (its trainer's) — the main
             phase's 64 crops through infer_precropped -b 16 (launches
             exactly K4 1, K2 6, K3 1, K1 1 a batch, 3 score images
             summing to 1 ± 1e-2, argmax ≥ 99% against f32 on the b16
             batch, forward ms and crops/s beside the flagship's) and
             --int8 (K4 1, K2-s8 6, K3-s8 1, K1 1 a batch; argmax ≥ 0.99
             against the int8 plain path); train_parity's gates and 5
             Adam steps on a b16 256² batch (K5 14, K1 16, K6 15, K4 1,
             K7 1 + 1 a step, the loss falls; step ms, crops/s, peak
             memory); the train CLI with model.inplanes 32 on 64 256²
             events, 4 iterations and one validation (exact launches,
             finite losses); 4 classes (the precropped deploy's) — the
             64 crops bf16 and --int8 (4 score images an event, the
             flagship's tables, K1 at (16, 4, 7)), train_parity with
             4-class labels under its gates. The phase's seconds.
15. widths_8 — the UResNets at 8-channel streams (inplanes 8 and 4,
             seeded random weights), every layer JAX fuses on its
             kernel's 8-channel instance: the 64 crops through
             infer_precropped -b 16 (launches exactly K2 6, K3 2, K1 2
             a batch at 8; K2 3, K3 2, K1 4 at 4; no stem pool), and
             --int8 (the same on K2-s8, K3-s8, K1-s8, the classifier on
             K1), each under the widths phase's gates and timings;
             train_parity's gates and 5 Adam steps on the b16 512²
             batch (K5 16 or 10, K1 18 or 12, K6 17 or 11, K7 1 + 1 a
             step), then the same with fused_train_deconv (+ K3 2, K10
             2: dec2 and dec1, JAX's deconv-AD gate). ASPP-ResNet
             at inplanes 32 through infer_precropped bf16 (K2 6, K3 1,
             K1 1 a batch) and --int8 (K2-s8 6, K3-s8 1, K1 1). The
             phase's seconds.
16. summary — the kernels line (K1-K9, K1-s8, K2-s8, K3-s8) with the
             launches of every path (wholeview, serve, root, the aspp
             paths, distributed, golden, the widths and widths_8 paths
             among them), the times at the main cell and, under at_shapes, at
             the other cells; before it the seconds of each phase; the
             card line, the result line.

Scratch files go under build/chip_smoke in the checkout.
"""
import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
INT8_TENSOR_OPS = 1979e12   # H100 SXM dense int8 tensor cores
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
EVENTS, BATCH_MAIN, HW = 64, 16, (512, 512)
MAIN_CELL = f"b{BATCH_MAIN} {HW[0]}x{HW[1]}"
# wholeview: synthetic whole planes (1008x3456, plane 2), the zone's
# batch and input at the stitched path's crop chunk (10 crops of
# 512x832) and the spatial path's padded plane (1 x 1024x3456)
WV_EVENTS, WV_HW, WV_CALIB = 4, (1008, 3456), 2
WV_SHAPES = ((10, (512, 832)), (1, (1024, 3456)))
SERVE_CROPS = 16            # events in each precropped file of the serve run
INT8_CALIB = 32             # --int8-calib: crops the CLI calibrates on
LAUNCHES_PER_BATCH = {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
                      "maxpool3x3s2": 1}
# the int8 forward: 9 of its 11 launches int8 (2 of the 6 blocks dual)
LAUNCHES_PER_BATCH_INT8 = {"conv_bn_act_s8": 1, "basic_block_s8": 6,
                           "deconv2x_s8": 2, "maxpool3x3s2": 1,
                           "conv_bn_act": 1}
LAUNCHES_PER_TRAIN_STEP = {"conv_stats": 16, "conv_bn_act": 18,
                           "conv_dw": 17, "maxpool3x3s2": 1,
                           "weighted_nll": 1, "weighted_nll_bwd": 1}
# with Policy.fused_train_deconv: the decoder upsamples' forward (K3) and
# backward (K10: dx and dW in one launch; K8 and K9 run on no path)
LAUNCHES_PER_DECONV_STEP = {**LAUNCHES_PER_TRAIN_STEP, "deconv2x": 2,
                            "deconv2x_bwd": 2}
# a validation forward under QAT: blocks per conv (cuDNN), no K2
LAUNCHES_PER_QAT_VALID = {"conv_bn_act": 2, "deconv2x": 2,
                          "maxpool3x3s2": 1}
TRAIN_ITERS, VALID_EVERY = 8, 4
QAT_ITERS, LADDER_STEPS = 4, 10
# launches a train step adds under remat: stage remat (Policy.remat)
# recomputes enc1, dec2 and dec1 in backward, their 15 BN-fed zone
# convs (K5; the stem and the head are in no stage); whole-forward
# remat (the step's remat) recomputes the forward: K5 16, the stem pool
# K4 1 and the classifier's forward K1 1 (the loss K7 is outside it)
REMAT_EXTRA = {"model_remat": {"conv_stats": 15},
               "remat": {"conv_stats": 16, "maxpool3x3s2": 1,
                         "conv_bn_act": 1}}
TRACE_ITERS = 2             # iterations of the root phase's --trace run
# kernels line entry → (source, the TPU kernel it replaces, row kernels,
# the paths that must launch it)
PALLAS = "ubresnet_tpu/ops/pallas_conv.py"
SOURCES = {
    "conv_bn_act": ("ubresnet_tpu_torch/ops/csrc/conv_bn_act.cu",
                    f"{PALLAS}:315 fused_packed_conv"
                    " + :1811 pallas_conv_ad (forward, dx)",
                    ("conv_bn_act",),
                    ("precropped", "train", "train_deconv", "qat", "int8",
                     "wholeview", "serve", "root", "aspp", "aspp_int8",
                     "aspp_train", "distributed", "golden", "widths_32",
                     "widths_32_int8", "widths_32_train", "widths_4",
                     "widths_4_int8", "widths_4_train", "widths_ip8",
                     "widths_ip4", "widths_ip8_int8", "widths_ip4_int8",
                     "widths_ip8_train", "widths_ip4_train",
                     "widths_ip8_train_deconv", "widths_ip4_train_deconv",
                     "aspp_32", "aspp_32_int8", "spatial_devices",
                     "model_axis")),
    "basic_block": ("ubresnet_tpu_torch/ops/csrc/basic_block.cu",
                    f"{PALLAS}:1483 fused_basic_block"
                    " + :699 fused_dual_block", ("basic_block",),
                    ("precropped", "train", "wholeview", "serve", "root",
                     "aspp", "golden", "widths_32", "widths_32_train",
                     "widths_4", "widths_ip8", "widths_ip4", "aspp_32",
                     "spatial_devices")),
    "deconv2x": ("ubresnet_tpu_torch/ops/csrc/deconv2x.cu",
                 f"{PALLAS}:898 fused_packed_deconv2x"
                 " + :1341 pallas_deconv2x_ad (forward)",
                 ("deconv2x",), ("precropped", "train", "train_deconv",
                                 "qat", "wholeview", "serve", "root", "aspp",
                                 "aspp_train", "golden", "widths_32",
                                 "widths_4", "widths_ip8", "widths_ip4",
                                 "widths_ip8_train_deconv",
                                 "widths_ip4_train_deconv", "aspp_32",
                                 "spatial_devices")),
    "maxpool3x3s2": ("ubresnet_tpu_torch/ops/csrc/maxpool3x3s2.cu",
                     f"{PALLAS}:525 fused_pool3x3s2"
                     " + ubresnet_tpu/ops/pool_ad.py:133 packed_pool_ad "
                     "(forward)", ("maxpool3x3s2",),
                     ("precropped", "train", "train_deconv", "qat", "int8",
                      "wholeview", "serve", "root", "aspp", "aspp_int8",
                      "aspp_train", "distributed", "golden", "widths_32",
                      "widths_32_int8", "widths_32_train", "widths_4",
                      "widths_4_int8", "widths_4_train", "spatial_devices",
                      "model_axis")),
    "conv_stats": ("ubresnet_tpu_torch/ops/csrc/conv_stats.cu",
                   "ubresnet_tpu/ops/pallas_train.py:206 train_conv_stats",
                   ("conv_stats",), ("train", "train_deconv", "qat", "root",
                                     "aspp_train", "distributed",
                                     "widths_32_train", "widths_4_train",
                                     "widths_ip8_train", "widths_ip4_train",
                                     "widths_ip8_train_deconv",
                                     "widths_ip4_train_deconv",
                                     "model_axis")),
    "conv_dw": ("ubresnet_tpu_torch/ops/csrc/conv_dw.cu",
                f"{PALLAS}:1677 pallas_conv_dw", ("conv_dw",),
                ("train", "train_deconv", "qat", "root", "aspp_train",
                 "distributed", "widths_32_train", "widths_4_train",
                 "widths_ip8_train", "widths_ip4_train",
                 "widths_ip8_train_deconv", "widths_ip4_train_deconv",
                 "model_axis")),
    "weighted_nll": ("ubresnet_tpu_torch/ops/csrc/weighted_nll.cu",
                     "ubresnet_tpu/ops/pallas_loss.py:100 "
                     "pallas_weighted_nll", ("weighted_nll",
                                             "weighted_nll_bwd"),
                     ("train", "train_deconv", "qat", "root", "aspp_train",
                      "distributed", "widths_32_train", "widths_4_train",
                      "widths_ip8_train", "widths_ip4_train",
                      "widths_ip8_train_deconv", "widths_ip4_train_deconv",
                      "model_axis")),
    # K8 and K9 compute one leg each of the deconv's backward, which K10
    # runs on every path: they are held and timed alone, on no path
    "conv_s2k4": ("ubresnet_tpu_torch/ops/csrc/conv_s2k4.cu",
                  f"{PALLAS}:1148 fused_conv_s2k4 (the dx leg of :1341 "
                  "pallas_deconv2x_ad)", ("conv_s2k4",), ()),
    "deconv_dw": ("ubresnet_tpu_torch/ops/csrc/deconv_dw.cu",
                  f"{PALLAS}:1265 pallas_deconv_dw (the dW leg of :1341 "
                  "pallas_deconv2x_ad)", ("deconv_dw",), ()),
    "deconv2x_bwd": ("ubresnet_tpu_torch/ops/csrc/deconv2x_bwd.cu",
                     f"{PALLAS}:1341 pallas_deconv2x_ad (backward, "
                     "_deconv_ad_bwd :1355: :1148 fused_conv_s2k4 + :1265 "
                     "pallas_deconv_dw)", ("deconv2x_bwd",),
                     ("train_deconv", "widths_ip8_train_deconv",
                      "widths_ip4_train_deconv")),
    "conv_bn_act_s8": ("ubresnet_tpu_torch/ops/csrc/conv_bn_act_s8.cu",
                       f"{PALLAS}:315 fused_packed_conv (_conv_kernel :251,"
                       " quantized :282-300)", ("conv_bn_act_s8",),
                       ("int8", "wholeview", "aspp_int8", "widths_4_int8",
                        "widths_ip8_int8", "widths_ip4_int8",
                        "spatial_devices")),
    "basic_block_s8": ("ubresnet_tpu_torch/ops/csrc/basic_block_s8.cu",
                       f"{PALLAS}:1483 fused_basic_block (_block_kernel "
                       ":1372) + :699 fused_dual_block (_dual_block_kernel"
                       " :587), quantized", ("basic_block_s8",),
                       ("int8", "wholeview", "aspp_int8", "widths_32_int8",
                        "widths_4_int8", "widths_ip8_int8", "widths_ip4_int8",
                        "aspp_32_int8", "spatial_devices")),
    "deconv2x_s8": ("ubresnet_tpu_torch/ops/csrc/deconv2x_s8.cu",
                    f"{PALLAS}:898 fused_packed_deconv2x (_deconv_kernel "
                    ":847), quantized", ("deconv2x_s8",),
                    ("int8", "wholeview", "aspp_int8", "widths_32_int8",
                     "widths_4_int8", "widths_ip8_int8", "widths_ip4_int8",
                     "aspp_32_int8", "spatial_devices")),
}
# the train zone at batch 16: (ci, co, k) of each distinct conv, the
# resolution it runs at and how many of the step's 16 BN-fed zone convs
# have that shape (models/uresnet.py:TrainUResNet)
TRAIN_ZONE = [((16, 32, 3), 256, 1), ((16, 32, 1), 256, 1),
              ((32, 32, 3), 256, 6), ((64, 32, 3), 256, 1),
              ((64, 32, 1), 256, 1), ((32, 16, 3), 512, 1),
              ((32, 16, 1), 512, 1), ((16, 16, 3), 512, 3),
              ((16, 16, 7), 512, 1)]
CLASSIFIER = ((16, 3, 7), 512, 1)
# the reference's other two UResNets (widths phase): the trainer's at
# inplanes 32 and the precropped deploy's 4-class model. Per batch at
# inplanes 32 (JAX fuses neither dec2's (128, 64) upsample nor the head
# conv10 (32, 16, 7)): K4 1, K2 6, K3 1, K1 1 (the classifier); int8 the
# same with K2-s8 and K3-s8. Per train step: K5 14 (dec2's first conv
# stays off), K1 14 + 2 (dx legs, the classifier's forward and dx), K6
# 15, K4 1, K7 1 + 1. The train zone at batch 16 on the reference
# trainer's 256² crops: (ci, co, k), resolution, count.
LAUNCHES_PER_BATCH_32 = {"conv_bn_act": 1, "basic_block": 6, "deconv2x": 1,
                         "maxpool3x3s2": 1}
LAUNCHES_PER_BATCH_INT8_32 = {"basic_block_s8": 6, "deconv2x_s8": 1,
                              "maxpool3x3s2": 1, "conv_bn_act": 1}
LAUNCHES_PER_TRAIN_STEP_32 = {"conv_stats": 14, "conv_bn_act": 16,
                              "conv_dw": 15, "maxpool3x3s2": 1,
                              "weighted_nll": 1, "weighted_nll_bwd": 1}
TRAIN_HW_32 = (256, 256)
TRAIN_ZONE_32 = [((32, 64, 3), 128, 1), ((32, 64, 1), 128, 1),
                 ((64, 64, 3), 128, 6), ((128, 64, 1), 128, 1),
                 ((64, 32, 3), 256, 1), ((64, 32, 1), 256, 1),
                 ((32, 32, 3), 256, 3)]
CLASSIFIER_32 = ((16, 3, 7), 256, 1)
CLASSIFIER_4 = ((16, 4, 7), 512, 1)
# K2 / K2-s8 layers of the inplanes-32 UResNet whose weights stream
STREAMED = {"enc1.res2", "dec2.res.res1", "dec2.res.res2"}
STREAMED_S8 = {"dec2.res.res1"}
WIDTHS_ITERS = 4            # train CLI iterations at inplanes 32
# the UResNets at 8-channel streams (widths_8 phase): inplanes 8 and 4,
# 3 classes, on the flagship's 512² crops. No stem pool (8 or 4
# channels at pack 8 fill no lane tile). Per batch at 8: K2 6 (enc1.res1
# (8, 0, 16), dec1's (8, 8, 8) and (8, 0, 8) among them), K3 2, K1 2 (the
# head conv10 (8, 16, 7), the classifier); at 4: K2 3 (enc1.res2, dec2's
# blocks at 8 channels), K3 2, K1 4 (the per-conv blocks' (8, 8, 3),
# (8, 4, 3), (8, 4, 1) and the classifier). int8 the same with K2-s8,
# K3-s8 and K1-s8 (the classifier stays bf16 K1). Per train step: K5 16
# or 10, K1 18 or 12, K6 17 or 11, K7 1 + 1; with fused_train_deconv
# also K3 2, K10 2 (dec2 and dec1).
LAUNCHES_PER_BATCH_8 = {
    8: {"basic_block": 6, "deconv2x": 2, "conv_bn_act": 2},
    4: {"basic_block": 3, "deconv2x": 2, "conv_bn_act": 4}}
LAUNCHES_PER_BATCH_INT8_8 = {
    8: {"basic_block_s8": 6, "deconv2x_s8": 2, "conv_bn_act_s8": 1,
        "conv_bn_act": 1},
    4: {"basic_block_s8": 3, "deconv2x_s8": 2, "conv_bn_act_s8": 3,
        "conv_bn_act": 1}}
LAUNCHES_PER_TRAIN_STEP_8 = {
    ip: {"conv_stats": n, "conv_bn_act": n + 2, "conv_dw": n + 1,
         "weighted_nll": 1, "weighted_nll_bwd": 1}
    for ip, n in ((8, 16), (4, 10))}
LAUNCHES_PER_DECONV_STEP_8 = {
    ip: {**t, "deconv2x": 2, "deconv2x_bwd": 2}
    for ip, t in LAUNCHES_PER_TRAIN_STEP_8.items()}
# their train zones at batch 16 on 512² crops, as TRAIN_ZONE, and their
# deconv-AD upsamples (name, input side, ci, co)
TRAIN_ZONE_8 = {
    8: [((8, 16, 3), 256, 1), ((8, 16, 1), 256, 1), ((16, 16, 3), 256, 6),
        ((32, 16, 3), 256, 1), ((32, 16, 1), 256, 1), ((16, 8, 3), 512, 1),
        ((16, 8, 1), 512, 1), ((8, 8, 3), 512, 3), ((8, 16, 7), 512, 1)],
    4: [((8, 8, 3), 256, 6), ((16, 8, 3), 256, 1), ((16, 8, 1), 256, 1),
        ((8, 4, 3), 512, 1), ((8, 4, 1), 512, 1)]}
DECONV_AD_8 = {8: (("dec2", 128, 32, 16), ("dec1", 256, 16, 8)),
               4: (("dec2", 128, 16, 8), ("dec1", 256, 8, 4))}
# ASPP-ResNet at inplanes 32 (zone pack 8): per batch K2 6, K3 1 (dec1),
# K1 1 (the classifier); int8 K2-s8 6, K3-s8 1, K1 1
LAUNCHES_PER_BATCH_ASPP_32 = {"basic_block": 6, "deconv2x": 1,
                              "conv_bn_act": 1}
LAUNCHES_PER_BATCH_INT8_ASPP_32 = {"basic_block_s8": 6, "deconv2x_s8": 1,
                                   "conv_bn_act": 1}


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms=150.0):
    """Mean ms per call over a CUDA-event-timed loop after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(got, want):
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def bf16_check(got, want):
    """One bf16 rounding step of the output: ≤ 1e-2·max|plain|."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"kernel {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    err, ref = _max_err(got, want)
    return err, ref, 1e-2 * ref, {}


def exact_check(got, want):
    err, ref = _max_err(got, want)
    return err, ref, 0.0, {}


def f32_check(rel):
    def check(got, want):
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"kernel {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(want.shape)} {want.dtype}")
        err, ref = _max_err(got, want)
        return err, ref, rel * ref, {}
    return check


def stats_check(got, want):
    """K5: y as a bf16 output; s1 and s2 (f32 sums of the bf16 y) within
    1e-3·max|plain| each (reported beside y's error). Also reported, not
    gated: the largest shift of a channel's mean of y from the plain
    version's, over that channel's std — the bias BatchNorm would carry."""
    err, ref, tol, _ = bf16_check(got[0], want[0])
    yk, yp = got[0].double(), want[0].double()
    extra = {"y_mean_shift_over_std": float(
        ((yk - yp).mean((0, 1, 2)) / yp.std((0, 1, 2))).abs().max())}
    del yk, yp
    for name, g, w in (("s1", got[1], want[1]), ("s2", got[2], want[2])):
        e, r = _max_err(g, w)
        extra[f"{name}_err"], extra[f"{name}_ref"] = e, r
        require(e <= 1e-3 * r, f"conv_stats {name}: max abs err {e} > "
                               f"1e-3·{r}")
    return err, ref, tol, extra


def _row(layer, kernel, kfn, pfn, lfn, nbytes, ops, peak, check=bf16_check,
         library=None, per_step=0, per_step_ad=None, instance=None,
         same_bits=False, after=None, passes=1):
    """``per_step``: launches of this row's kernel at this shape in one
    train step; ``per_step_ad`` the same with fused_train_deconv
    (default: ``per_step``); ``instance``: the template arguments of the
    kernel this row launches, for its ptxas figures; ``same_bits``: a
    second launch must give the same bits in every output; ``after``:
    a function of the measured row whose dict of further measurements
    joins it."""
    return {"layer": layer, "kernel": kernel, "kfn": kfn, "pfn": pfn,
            "lfn": lfn, "bytes": nbytes, "ops": ops, "peak": peak,
            "check": check, "library": library, "per_step": per_step,
            "per_step_ad": per_step if per_step_ad is None else per_step_ad,
            "instance": instance, "same_bits": same_bits, "after": after,
            "passes": passes}


# demangled kernel name → its ptxas figures, filled after the build
PTXAS = {}


def _template_args(name):
    """A demangled kernel name with its template arguments as plain
    values: casts dropped (<(int)16, (bool)1> → <16, 1>), true/false as
    1/0."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    return re.sub(r"\bfalse\b", "0", re.sub(r"\btrue\b", "1", name))


def ptxas_of(kernel, instance):
    """Registers, spills and stack of ``<kernel>_kernel<instance>`` from
    the build's ptxas logs (None where the row names no instance);
    instance holds ints, bools and type names (``__nv_bfloat16``)."""
    if instance is None:
        return None
    args = ", ".join(str(int(v)) if isinstance(v, bool) else str(v)
                     for v in instance)
    name = f"{kernel}_kernel<{args}>"
    # K2 and K2-s8 instances whose weights do not fit shared memory
    # compile as the streamed form
    streamed = f"{kernel}_streamed_kernel<{args}>"
    hit = [dict(v, form="streamed" if _template_args(k).endswith(streamed)
                else "resident") if kernel.startswith("basic_block") else v
           for k, v in PTXAS.items()
           if _template_args(k).endswith((name, streamed))]
    return hit[0] if hit else {"missing": name}


def _cell(B, hw):
    """A row's cell: its batch and the forward's input size."""
    return f"b{B} {hw[0]}x{hw[1]}"


def _tagged(rows, B, hw, model=""):
    """Mark rows with their cell (``model``: the UResNet they belong to
    when not the flagship); rows outside the main cell name it in their
    layer and count in no train step."""
    cell = _cell(B, hw) + (f" {model}" if model else "")
    for r in rows:
        r["cell"] = cell
        if cell != MAIN_CELL:
            r["layer"] += f" @{cell}"
            r["per_step"] = r["per_step_ad"] = 0
    return rows


def zone_layers(inplanes=16, classes=3):
    """The kernel-zone layers of a UResNet's eval forward where the JAX
    package fuses them (models/blocks.py routes, at the zone's widths):
    [(layer, kind, shape, resolution divisor)], kind "pool" (C),
    "block" (ca, cb, co, proj), "deconv" (ci, co) at its input's
    divisor, "conv" (ci, co, k). A block JAX runs per conv (at
    inplanes 4: enc1.res1, dec1's) gives the convs it fuses there
    ("<block> cb1", "<block> bypass", "<block> cb2")."""
    from ubresnet_tpu_torch.models import blocks
    from ubresnet_tpu_torch.models.uresnet import UResNetConfig, zone_packs

    c = inplanes
    packs = zone_packs(UResNetConfig(inplanes=c, num_classes=classes))
    out = []
    if blocks.pool_fuses(c, 2, 2 * packs["stem"], packs["stem"]):
        out.append(("stem pool", "pool", (c,), 1))

    def block(name, ca, cb, co, proj, div, pack):
        if blocks.block_fuses(ca, cb, co, proj, None, pack):
            out.append((name, "block", (ca, cb, co, proj), div))
            return
        cin = ca + cb
        for tag, ci, k in (("cb1", cin, 3), ("bypass", cin, 1),
                           ("cb2", co, 3)):
            if (tag != "bypass" or proj) and blocks.conv_fuses(ci, k, None,
                                                               pack):
                out.append((f"{name} {tag}", "conv", (ci, co, k), div))

    def deconv(name, ci, co, div, pack):
        if blocks.deconv_fuses(ci, None, pack):
            out.append((name, "deconv", (ci, co), div))

    block("enc1.res1", c, 0, 2 * c, True, 2, packs["enc1"])
    block("enc1.res2", 2 * c, 0, 2 * c, False, 2, packs["enc1"])
    deconv("dec2.deconv", 4 * c, 2 * c, 4, packs["dec2"])
    block("dec2.res.res1", 2 * c, 2 * c, 2 * c, True, 2, packs["dec2"])
    block("dec2.res.res2", 2 * c, 0, 2 * c, False, 2, packs["dec2"])
    deconv("dec1.deconv", 2 * c, c, 2, packs["dec1"])
    block("dec1.res.res1", c, c, c, True, 1, packs["dec1"])
    block("dec1.res.res2", c, 0, c, False, 1, packs["dec1"])
    if blocks.conv_fuses(c, 7, None, packs["head"]):
        out.append(("head conv10", "conv", (c, 16, 7), 1))
    if blocks.classifier_fuses(16, packs["head"]):
        out.append(("classifier conv11", "conv", (16, classes, 7), 1))
    return out


def _model_tag(inplanes, classes):
    """The cell suffix of a UResNet other than the flagship."""
    return " ".join(t for t in (
        f"inplanes {inplanes}" if inplanes != 16 else "",
        f"{classes} classes" if classes != 3 else "") if t)


def kernel_rows(dev, B=BATCH_MAIN, hw=HW, inplanes=16, classes=3,
                only=None):
    """One row per kernel-zone layer (``zone_layers``) of the eval
    forward of the UResNet at ``inplanes`` and ``classes`` (default: the
    flagship) at batch ``B`` and input ``hw`` (default: the main
    path's); ``only``: the layers to take (default: all)."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import block, conv, deconv, pool

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    H, W = hw
    H2, W2 = H // 2, W // 2

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def weight(*shape, fan):
        return (torch.randn(*shape, generator=gen, device=dev)
                * (2.0 / fan) ** 0.5).to(bf).contiguous()

    def affine(c):
        g = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        return g, 0.05 * torch.randn(c, generator=gen, device=dev)

    def cl(x):  # NHWC → channels-last NCHW view
        return x.permute(0, 3, 1, 2)

    def folded(w_hwio, g):  # (k, k, ci, co) + gain → OIHW bf16, channels last
        return (w_hwio.float() * g).permute(3, 2, 0, 1).to(bf).contiguous(
            memory_format=torch.channels_last)

    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    # K4 stem pool: full resolution -> half
    def pool_row(name, c):
        x = act(B, H, W, c)
        out_elems = B * H2 * W2 * c
        rows.append(_row(name, "maxpool3x3s2",
                         lambda x=x: pool.maxpool3x3s2(x),
                         lambda x=x: pool.maxpool3x3s2_plain(x),
                         lambda x=x: F.max_pool2d(cl(x), 3, 2, 1),
                         n2(x) + out_elems * 2, 8 * out_elems, F32_FLOPS,
                         check=exact_check, library="F.max_pool2d",
                         per_step=1))

    # K2 blocks
    def block_row(name, hw, ca, cb, co, proj):
        a = act(B, *hw, ca)
        b = act(B, *hw, cb) if cb else None
        cin = ca + cb
        w1 = weight(3, 3, cin, co, fan=9 * co)
        w2 = weight(3, 3, co, co, fan=9 * co)
        (g1, b1), (g2, b2), (gb, bb) = affine(co), affine(co), affine(co)
        wb = weight(cin, co, fan=co) if proj else None
        args = (a, b, w1, g1, b1, w2, g2, b2, wb,
                gb if proj else None, bb if proj else None)
        lw1, lw2 = folded(w1, g1), folded(w2, g2)
        lb1, lb2 = b1.to(bf), b2.to(bf)
        lwb = folded(wb.view(1, 1, cin, co), gb) if proj else None
        lbb = bb.to(bf)

        def library(a=a, b=b):
            x = cl(a) if b is None else torch.cat([cl(a), cl(b)], 1)
            y = torch.relu(F.conv2d(x, lw1, lb1, padding=1))
            y = torch.relu(F.conv2d(y, lw2, lb2, padding=1))
            r = F.conv2d(x, lwb, lbb) if proj else x
            return torch.relu(y + r)

        pix = B * hw[0] * hw[1]
        macs = pix * (9 * cin * co + 9 * co * co + (cin * co if proj else 0))
        nbytes = n2(a) + (n2(b) if cb else 0) + pix * co * 2 + n2(w1) + n2(w2)
        rows.append(_row(name, "basic_block",
                         lambda: block.basic_block(*args),
                         lambda: block.basic_block_plain(*args),
                         library, nbytes, 2 * macs, BF16_TENSOR_FLOPS,
                         library="cuDNN block sequence",
                         instance=(ca, cb, co, proj)))

    def deconv_row(name, hw, ci, co):
        x = act(B, *hw, ci)
        w = weight(4, 4, ci, co, fan=16 * co)
        w_iohw = w.permute(2, 3, 0, 1).contiguous()
        out_pix = B * 4 * hw[0] * hw[1]
        rows.append(_row(name, "deconv2x",
                         lambda: deconv.deconv2x(x, w),
                         lambda: deconv.deconv2x_plain(x, w),
                         lambda: F.conv_transpose2d(cl(x), w_iohw, stride=2,
                                                    padding=1),
                         n2(x) + out_pix * co * 2 + n2(w),
                         2 * out_pix * 4 * ci * co, BF16_TENSOR_FLOPS,
                         library="F.conv_transpose2d", per_step_ad=1))

    # K1: the head conv10 (BN + ReLU), the classifier conv11 (bias only:
    # g = 1, no ReLU), a per-conv block's fused convs (the bypass: BN,
    # no ReLU)
    def conv_row(name, hw, ci, co, k):
        classifier = name == "classifier conv11"
        act_on = not classifier and not name.endswith("bypass")
        x = act(B, *hw, ci)
        w = weight(k, k, ci, co, fan=k * k * co)
        g, b = affine(co)
        if classifier:
            g = torch.ones(co, device=dev)
        lw, lb = folded(w, g), b.to(bf)

        def library():
            y = F.conv2d(cl(x), lw, lb, padding=k // 2)
            return torch.relu_(y) if act_on else y

        pix = B * hw[0] * hw[1]
        rows.append(_row(name, "conv_bn_act",
                         lambda: conv.conv_bn_act(x, w, g, b, act=act_on),
                         lambda: conv.conv_bn_act_plain(x, w, g, b,
                                                        act=act_on),
                         library, n2(x) + pix * co * 2 + n2(w),
                         2 * pix * k * k * ci * co, BF16_TENSOR_FLOPS,
                         library="F.conv2d + folded affine",
                         per_step=int(classifier),  # conv_ad's forward
                         instance=(ci, co, k)))

    for name, kind, shape, div in zone_layers(inplanes, classes):
        if only is not None and name not in only:
            continue
        at = (H // div, W // div)
        if kind == "pool":
            pool_row(name, *shape)
        elif kind == "block":
            block_row(name, at, *shape)
        elif kind == "deconv":
            deconv_row(name, at, *shape)
        else:
            conv_row(name, at, *shape)
    return _tagged(rows, B, hw, _model_tag(inplanes, classes))


# K6 rows: ms and cuDNN's ms are the median of this many passes
DW_PASSES = 5


def dw_scratch(ci, co, k, B, hw, dev):
    """K6's launch geometry at one row's shape and the bytes of its
    cross-cluster scratch: each cluster writes one (k, k, ci, co) f32
    row, which sum_rows reads back."""
    from ubresnet_tpu_torch.ops import conv

    g = conv.dw_grid(ci, co, k, B, hw, hw, dev)
    return {"dw_grid": g,
            "scratch_bytes": 2 * g["clusters"] * k * k * ci * co * 4}


def train_kernel_rows(dev, zone=TRAIN_ZONE, classifier=CLASSIFIER,
                      classes=3, model="", cell_hw=HW, loss_rows=True):
    """One row per distinct shape of the train zone at batch 16 and its
    own resolution (default: the flagship's): K5 forward (9), K1 input
    gradient (10), K6 weight gradient (10), K7 forward and backward at
    (16, 512, 512, ``classes``). ``model``: the cell suffix of another
    UResNet (its rows count in no flagship step), whose crops are
    ``cell_hw``; ``loss_rows``: the K7 rows too."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import conv, loss, train_conv

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    B = BATCH_MAIN
    rows = []

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def grad(*shape):
        return (0.01 * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def weight(k, ci, co):
        return (torch.randn(k, k, ci, co, generator=gen, device=dev)
                * (2.0 / (k * k * co)) ** 0.5).to(bf).contiguous()

    def cl(x):
        return x.permute(0, 3, 1, 2)

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    for (ci, co, k), hw, count in zone:
        x = act(B, hw, hw, ci)
        w = weight(k, ci, co)
        bias = 0.05 * torch.randn(co, generator=gen, device=dev)
        pix = B * hw * hw
        macs = pix * k * k * ci * co
        lw, lb = oihw(w), bias.to(bf)

        def library(x=x, lw=lw, lb=lb, k=k):
            y = F.conv2d(cl(x), lw, lb, padding=k // 2).float()
            return y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))

        rows.append(_row(
            f"K5 {ci}->{co} k{k} @{hw}", "conv_stats",
            lambda x=x, w=w, b=bias: train_conv.conv_stats(x, w, b),
            lambda x=x, w=w, b=bias: train_conv.conv_stats_plain(x, w, b),
            library, pix * (ci + co) * 2 + w.numel() * 2 + co * 8,
            2 * macs, BF16_TENSOR_FLOPS, check=stats_check,
            library="F.conv2d + two channel sums", per_step=count,
            instance=(ci, co, k), same_bits=True))

    for (ci, co, k), hw, count in zone + [classifier]:
        dy = grad(B, hw, hw, co)
        w = weight(k, ci, co)
        wt = w.flip((0, 1)).transpose(2, 3)
        ones = torch.ones(ci, device=dev)
        zeros = torch.zeros(ci, device=dev)
        pix = B * hw * hw
        macs = pix * k * k * ci * co
        lw = oihw(w)
        rows.append(_row(
            f"K1 dx {ci}<-{co} k{k} @{hw}", "conv_bn_act",
            lambda dy=dy, w=w: conv.conv_input_grad(dy, w),
            lambda dy=dy, wt=wt, o=ones, z=zeros: conv.conv_bn_act_plain(
                dy, wt, o, z, act=False),
            lambda dy=dy, lw=lw, ci=ci, hw=hw, k=k:
                torch.nn.grad.conv2d_input((B, ci, hw, hw), lw, cl(dy),
                                           padding=k // 2),
            pix * (ci + co) * 2 + w.numel() * 2, 2 * macs, BF16_TENSOR_FLOPS,
            library="torch.nn.grad.conv2d_input", per_step=count,
            instance=(-(-co // 4) * 4, ci, k)))

        x = act(B, hw, hw, ci)
        rows.append(_row(
            f"K6 dW {ci}->{co} k{k} @{hw}", "conv_dw",
            lambda x=x, dy=dy, k=k: conv.conv_dw(x, dy, k),
            lambda x=x, dy=dy, k=k: conv.conv_dw_plain(x, dy, k),
            lambda x=x, dy=dy, ci=ci, co=co, k=k:
                torch.nn.grad.conv2d_weight(cl(x), (co, ci, k, k), cl(dy),
                                            padding=k // 2),
            pix * (ci + co) * 2 + k * k * ci * co * 4, 2 * macs,
            BF16_TENSOR_FLOPS, check=f32_check(1e-3),
            library="torch.nn.grad.conv2d_weight", per_step=count,
            instance=(ci, co, k), same_bits=True, passes=DW_PASSES,
            after=lambda row, ci=ci, co=co, k=k, hw=hw: dw_scratch(
                ci, co, k, B, hw, dev)))

    if not loss_rows:
        return _tagged(rows, B, cell_hw, model)
    n, C = B * 512 * 512, classes
    logits = 3 * torch.randn(B, 512, 512, C, generator=gen, device=dev)
    labels = torch.randint(0, C, (B, 512, 512), generator=gen, device=dev,
                           dtype=torch.int32)
    weights = 2 * torch.rand(B, 512, 512, generator=gen, device=dev)
    g = torch.tensor(1.0, device=dev)
    lt = logits.permute(0, 3, 1, 2)
    lab64 = labels.long()

    def library_fwd(lt=lt):
        return (F.cross_entropy(lt, lab64, reduction="none") * weights).mean()

    lreq = lt.detach().clone().requires_grad_(True)
    lib_loss = library_fwd(lreq)
    rows.append(_row(
        f"K7 loss forward (16,512,512,{C})", "weighted_nll",
        lambda: loss.weighted_nll_fwd(logits, labels, weights),
        lambda: loss.weighted_nll_fwd_plain(logits, labels, weights),
        library_fwd, n * (4 * C + 4 + 4) + 4, (7 * C - 1) * n, F32_FLOPS,
        check=f32_check(1e-5),
        library="F.cross_entropy(reduction='none')·w, mean", per_step=1))
    rows.append(_row(
        f"K7 loss backward (16,512,512,{C})", "weighted_nll_bwd",
        lambda: loss.weighted_nll_bwd(logits, labels, weights, g),
        lambda: loss.weighted_nll_bwd_plain(logits, labels, weights, g),
        lambda: torch.autograd.grad(lib_loss, lreq, retain_graph=True),
        n * (4 * C + 4 + 4 + 4 * C), 10 * C * n, F32_FLOPS,
        check=f32_check(1e-5),
        library="autograd backward of the forward's sequence", per_step=1))
    return _tagged(rows, B, cell_hw, model) if model else rows


def ad_check(got, want):
    """deconv2x_ad forward + backward: y and dx as bf16 outputs, the
    bf16 dW (rounded to the kernel's dtype, as in JAX) against the f32
    plain dW — each within one bf16 step, ≤ 1e-2·max|plain|."""
    err, ref, tol, _ = bf16_check(got[0], want[0].to(got[0].dtype))
    extra = {}
    for name, g, w in (("dx", got[1], want[1]), ("dw", got[2], want[2])):
        e, r = _max_err(g, w)
        extra[f"{name}_err"], extra[f"{name}_ref"] = e, r
        require(e <= 1e-2 * r, f"deconv2x_ad {name}: max abs err {e} > "
                               f"1e-2·{r}")
    return err, ref, tol, extra


def deconv_dw_f64(x, dy):
    """The deconv's dW in float64, tap by tap: dW[kr, kc] = xᵀ · dy at
    rows 2i + kr - 1, columns 2j + kc - 1 (zero outside dy), one matmul
    per tap over every pixel."""
    import torch
    import torch.nn.functional as F

    h, w, ci, co = x.shape[1], x.shape[2], x.shape[3], dy.shape[3]
    xm = x.double().reshape(-1, ci)
    dp = F.pad(dy.double(), (0, 0, 1, 1, 1, 1))
    return torch.stack([
        xm.T @ dp[:, kr:kr + 2 * h:2, kc:kc + 2 * w:2].reshape(-1, co)
        for kr in range(4) for kc in range(4)]).reshape(4, 4, ci, co)


def dw_check(x, dy):
    """K9: f32 dW within 1e-3·max|plain| (sums over 1-4 M pixels in
    another order). Also reported, not gated: the kernel's and the plain
    f32 version's largest distance from the float64 dW, against that
    dW's largest magnitude — the drift a long chain of tensor-core adds
    would show."""
    f32 = f32_check(1e-3)

    def check(got, want):
        err, ref, tol, extra = f32(got, want)
        exact = deconv_dw_f64(x, dy)
        return err, ref, tol, {
            **extra, "f64_max_abs": float(exact.abs().max()),
            "f64_max_abs_err": float((got.double() - exact).abs().max()),
            "plain_f64_max_abs_err": float(
                (want.double() - exact).abs().max())}
    return check


def bwd_check(x, dy):
    """K10: dx as a bf16 output (one bf16 step, as K8), dW as K9's
    (dw_check: ≤ 1e-3·max|plain|, the float64 distances reported)."""
    dw = dw_check(x, dy)

    def check(got, want):
        err, ref, tol, _ = bf16_check(got[0], want[0])
        e, r, t, extra = dw(got[1], want[1])
        require(e <= t, f"deconv2x_bwd dW: max abs err {e} > {t}")
        return err, ref, tol, {"dw_err": e, "dw_ref": r, **extra}
    return check


# the deconv-AD upsamples of the flagship (name, input side, ci, co)
DECONV_AD = (("dec2", 128, 64, 32), ("dec1", 256, 32, 16))


def deconv_ad_rows(dev, layers=DECONV_AD, model="", cell_hw=HW):
    """The decoder upsamples' backward at batch 16 and their own
    resolution (default: the flagship's, dec2: x 128² x 64 → 256² x 32,
    dec1: 256² x 32 → 512² x 16): K10 dx and dW, one launch per
    deconv-AD step, K8 dx and K9 dW alone (on no path), and deconv2x_ad
    forward + backward (K3, K10) against F.conv_transpose2d's autograd —
    its plain version in f32, its library call in bf16 (cuDNN) —, with
    its host µs a call beside its kernels' time. ``model``: the cell
    suffix of another UResNet (its rows count in no flagship step),
    whose crops are ``cell_hw``."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import deconv
    from ubresnet_tpu_torch.tools.kernel_ab import host_us

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    B = BATCH_MAIN
    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    for name, hw, ci, co in layers:
        x = torch.relu(torch.randn(B, hw, hw, ci, generator=gen,
                                   device=dev)).to(bf)
        dy = (0.01 * torch.randn(B, 2 * hw, 2 * hw, co, generator=gen,
                                 device=dev)).to(bf)
        w = (torch.randn(4, 4, ci, co, generator=gen, device=dev)
             * (2.0 / (16 * co)) ** 0.5).to(bf).contiguous()
        w_oihw = w.permute(2, 3, 0, 1).contiguous()  # (ci, co, 4, 4)
        macs = B * hw * hw * 16 * ci * co

        def cl(t):
            return t.permute(0, 3, 1, 2)

        # cuDNN's backward alone: the bf16 graph built once, its dgrad
        # and wgrad per call
        xl = cl(x).detach().requires_grad_()
        wl = w_oihw.detach().requires_grad_()
        yl = F.conv_transpose2d(xl, wl, stride=2, padding=1)
        rows.append(_row(
            f"K10 dx+dW {name} {ci}->{co} @{hw}", "deconv2x_bwd",
            lambda x=x, dy=dy, w=w: deconv.deconv2x_bwd(x, dy, w),
            lambda x=x, dy=dy, w=w: deconv.deconv2x_bwd_plain(x, dy, w),
            lambda xl=xl, wl=wl, yl=yl, dy=dy: torch.autograd.grad(
                yl, (xl, wl), cl(dy), retain_graph=True),
            n2(dy) + 2 * n2(x) + n2(w) + 16 * ci * co * 4, 4 * macs,
            BF16_TENSOR_FLOPS, check=bwd_check(x, dy),
            library="torch.autograd.grad of F.conv_transpose2d (cuDNN "
                    "bf16)", per_step_ad=1, instance=(ci, co),
            same_bits=True))
        rows.append(_row(
            f"K8 dx {name} {ci}<-{co} @{2 * hw}", "conv_s2k4",
            lambda dy=dy, w=w: deconv.conv_s2k4(dy, w),
            lambda dy=dy, w=w: deconv.conv_s2k4_plain(dy, w),
            lambda dy=dy, wo=w_oihw: F.conv2d(cl(dy), wo, stride=2,
                                              padding=1),
            n2(dy) + n2(x) + n2(w), 2 * macs, BF16_TENSOR_FLOPS,
            library="F.conv2d stride 2", per_step_ad=0, instance=(ci, co),
            same_bits=True))
        rows.append(_row(
            f"K9 dW {name} {ci}->{co} @{hw}", "deconv_dw",
            lambda x=x, dy=dy: deconv.deconv_dw(x, dy),
            lambda x=x, dy=dy: deconv.deconv_dw_plain(x, dy),
            lambda x=x, dy=dy, ci=ci, co=co: torch.nn.grad.conv2d_weight(
                cl(dy), (ci, co, 4, 4), cl(x), stride=2, padding=1),
            n2(x) + n2(dy) + 16 * ci * co * 4, 2 * macs, BF16_TENSOR_FLOPS,
            check=dw_check(x, dy), library="torch.nn.grad.conv2d_weight",
            per_step_ad=0, instance=(ci, co), same_bits=True))

        def ad(x=x, w=w, dy=dy):
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            y = deconv.deconv2x_ad(xr, wr)
            return (y.detach(), *torch.autograd.grad(y, (xr, wr), dy))

        def ad_plain(x=x, w=w, dy=dy, dtype=torch.float32):
            xr = x.detach().to(dtype).requires_grad_()
            wr = w.detach().permute(2, 3, 0, 1).to(dtype).requires_grad_()
            y = F.conv_transpose2d(cl(xr), wr, stride=2, padding=1)
            dx, dw = torch.autograd.grad(y, (xr, wr), cl(dy).to(dtype))
            return (y.permute(0, 2, 3, 1).detach(), dx,
                    dw.permute(2, 3, 0, 1))

        # the forward reads x and writes y (dy's size), the backward reads
        # x and dy and writes dx and dW: 3·x + 2·dy + w + dW (before K10:
        # 3·(x + dy), K8 and K9 each reading dy)
        before = 3 * (n2(x) + n2(dy)) + 2 * n2(w) + 16 * ci * co * 4

        def after(row, ad=ad, x=x, w=w, dy=dy, before=before):
            kern = (time_ms(lambda: deconv.deconv2x(x, w))
                    + time_ms(lambda: deconv.deconv2x_bwd(x, dy, w)))
            old = before / HBM_BYTES_PER_S * 1e3
            return {"host_us_per_call": host_us(ad), "kernels_ms": kern,
                    "bytes_before_k10": before, "bound_ms_before_k10": old,
                    "pct_of_bound_before_k10": old / row["ms"]}

        rows.append(_row(
            f"deconv2x_ad fwd+bwd {name} {ci}->{co} @{hw}", "deconv2x_ad",
            ad, ad_plain, lambda f=ad_plain: f(dtype=bf),
            3 * n2(x) + 2 * n2(dy) + n2(w) + 16 * ci * co * 4,
            3 * 2 * macs, BF16_TENSOR_FLOPS, check=ad_check,
            library="F.conv_transpose2d + autograd (cuDNN bf16)",
            after=after))
    return _tagged(rows, B, cell_hw, model) if model else rows


def s8_check(exact):
    """int8 rows: the kernel's and the plain version's float32 outputs
    (``exact()`` runs both; with g = 1, b = 0 for the conv and the
    deconv that output is the s32 accumulator itself) must be
    bit-identical — exact integer sums, the same f32 epilogue steps —
    and the bf16 outputs of the main path within one bf16 step."""
    def check(got, want):
        import torch

        err, ref, tol, _ = bf16_check(got, want)
        k32, p32 = exact()
        torch.cuda.synchronize()
        e32, _ = _max_err(k32, p32)
        require(torch.equal(k32, p32), f"int8 kernel's f32 output differs "
                                       f"from its plain version's by {e32}")
        return err, ref, tol, {"f32_exact": True, "f32_max_abs_err": e32}
    return check


def int8_kernel_rows(dev, eval_rows, B=BATCH_MAIN, hw=HW, inplanes=16,
                     only=None):
    """One row per int8-zone layer of the int8 forward at batch ``B``
    and input ``hw`` (default: the main path's) of the UResNet at
    ``inplanes`` (``zone_layers``; the flagship's: K1-s8 head conv10,
    K2-s8 the six blocks, two dual, K3-s8 the dec2 and dec1 upsamples;
    at inplanes 4 also K1-s8 at the per-conv blocks' fused convs).
    Inputs are int8 on the grid a
    calibrated model gives (post-ReLU activations, 0..127), weights
    int8, gains as the model folds them. No single PyTorch call computes
    an int8 conv, so library_ms is null; the bf16 kernel's and the cuDNN
    bf16 sequence's times of the same layer (``eval_rows``, this run)
    stand beside it for scale."""
    import torch

    from ubresnet_tpu_torch.ops import block, conv, deconv

    gen = torch.Generator(device=dev).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    H, W = hw
    model = _model_tag(inplanes, 3)
    cell = _cell(B, hw) + (f" {model}" if model else "")
    bf16_rows = {r["layer"]: r for r in eval_rows if r["cell"] == cell}
    tag = "" if cell == MAIN_CELL else f" @{cell}"
    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    def act(*shape):  # post-ReLU int8 activations
        return torch.randint(0, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def weight(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def gain(c, scale):
        g = torch.rand(c, generator=gen, device=dev) * scale
        return g, torch.randn(c, generator=gen, device=dev)

    def add(layer, kernel, kfn, pfn, exact, nbytes, macs, instance=None):
        r = _row(layer, kernel, kfn, pfn, None, nbytes, 2 * macs,
                 INT8_TENSOR_OPS, check=s8_check(exact), instance=instance)
        r["bf16"] = bf16_rows[layer + tag]
        rows.append(r)

    # K1-s8: the head conv10 (7x7, full resolution) and a per-conv
    # block's fused convs
    def conv_row(name, hw, ci, co, k):
        x, w = act(B, *hw, ci), weight(k, k, ci, co)
        g, b = gain(co, 2e-5 * (49 * 16 / (k * k * ci)) ** 0.5)
        one, zero = torch.ones(co, device=dev), torch.zeros(co, device=dev)
        pix = B * hw[0] * hw[1]
        add(name, "conv_bn_act_s8",
            lambda: conv.conv_bn_act_s8(x, w, g, b),
            lambda: conv.conv_bn_act_s8_plain(x, w, g, b),
            lambda: (conv.conv_bn_act_s8(x, w, one, zero, act=False,
                                         out_dtype=f32),
                     conv.conv_bn_act_s8_plain(x, w, one, zero, act=False,
                                               out_dtype=f32)),
            n2(x) + pix * co * 2 + n2(w), pix * k * k * ci * co,
            instance=(ci, co, k, "__nv_bfloat16"))

    def block_row(name, hw, ca, cb, co, proj):
        a = act(B, *hw, ca)
        bq = act(B, *hw, cb) if cb else None
        cin = ca + cb
        # conv1's s32 sum has std ≈ 5370·sqrt(9·cin) on these inputs:
        # this g1 spreads m over the int8 grid (std ≈ 30, tail at 127)
        g1, b1 = gain(co, 0.011 / (9 * cin) ** 0.5)
        g2, b2 = gain(co, 1e-4)
        if proj:
            gb, bb = gain(co, 1e-4)
        else:
            gb, bb = torch.full((co,), 0.05, device=dev), torch.zeros(
                co, device=dev)
        args = (a, bq, weight(3, 3, cin, co), g1, b1, weight(3, 3, co, co),
                g2, b2, weight(cin, co) if proj else None, gb, bb)
        p = B * hw[0] * hw[1]
        macs = p * (9 * cin * co + 9 * co * co + (cin * co if proj else 0))
        nbytes = (p * cin + p * co * 2 + n2(args[2]) + n2(args[5])
                  + (n2(args[8]) if proj else 0))
        add(name, "basic_block_s8",
            lambda: block.basic_block_s8(*args),
            lambda: block.basic_block_s8_plain(*args),
            lambda: (block.basic_block_s8(*args, out_dtype=f32),
                     block.basic_block_s8_plain(*args, out_dtype=f32)),
            nbytes, macs, instance=(ca, cb, co, proj, "__nv_bfloat16"))

    def deconv_row(name, hw, ci, co):
        xq, wq = act(B, *hw, ci), weight(4, 4, ci, co)
        gq, _ = gain(co, 1e-4)
        ones = torch.ones(co, device=dev)
        p = B * 4 * hw[0] * hw[1]
        add(name, "deconv2x_s8",
            lambda: deconv.deconv2x_s8(xq, wq, gq),
            lambda: deconv.deconv2x_s8_plain(xq, wq, gq),
            lambda: (deconv.deconv2x_s8(xq, wq, ones, out_dtype=f32),
                     deconv.deconv2x_s8_plain(xq, wq, ones, f32)),
            n2(xq) + p * co * 2 + n2(wq), p * 4 * ci * co,
            instance=(ci, co, "__nv_bfloat16"))

    layers = [lay for lay in zone_layers(inplanes)
              if only is None or lay[0] in only]
    for name, kind, shape, div in layers:
        if kind == "conv" and name != "classifier conv11":  # it stays bf16
            conv_row(name, (H // div, W // div), *shape)
    for name, kind, shape, div in layers:
        at = (H // div, W // div)
        if kind == "block":
            block_row(name, at, *shape)
        elif kind == "deconv":
            deconv_row(name, at, *shape)
    return _tagged(rows, B, hw, model)


def _ratios(r):
    """pct_of_bound = bound_ms / ms; vs_library = ms / library_ms (None
    without a library call): the same call's measurements."""
    lib = r["library_ms"]
    return {"pct_of_bound": r["bound_ms"] / r["ms"],
            "vs_library": None if lib is None else r["ms"] / lib}


def _timed(key, fn, passes):
    """{key: ms} of ``fn`` (None without one); over several passes the
    median, with ``key_min``, ``key_max`` and the passes beside it."""
    if fn is None:
        return {key: None}
    ts = [time_ms(fn) for _ in range(passes)]
    if passes == 1:
        return {key: ts[0]}
    return {key: statistics.median(ts), f"{key}_min": min(ts),
            f"{key}_max": max(ts), f"{key}_passes": ts}


def check_kernels(rows):
    import torch

    results = []
    for r in rows:
        got = r["kfn"]()
        want = r["pfn"]()
        torch.cuda.synchronize()
        err, ref, tol, extra = r["check"](got, want)
        if r["same_bits"]:
            again = r["kfn"]()
            torch.cuda.synchronize()
            pairs = zip(got, again) if isinstance(got, tuple) else [(got,
                                                                      again)]
            require(all(torch.equal(a, b) for a, b in pairs),
                    f"{r['layer']}: a second launch gave other bits")
            extra = {**extra, "same_bits": True}
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        if "bf16" in r:  # int8 rows: the same layer's bf16 times
            extra = {**extra, "bf16_kernel_ms": r["bf16"]["ms"],
                     "cudnn_bf16_ms": r["bf16"]["library_ms"],
                     "cudnn_bf16": r["bf16"]["library"]}
        row = {
            "phase": "kernel", "layer": r["layer"], "kernel": r["kernel"],
            "cell": r.get("cell", MAIN_CELL),
            "shape": list((got[0] if isinstance(got, tuple) else got).shape),
            "max_abs_err": err, "max_abs_ref": ref, "tolerance": tol,
            **extra, **_timed("ms", r["kfn"], r.get("passes", 1)),
            "plain_ms": time_ms(r["pfn"]),
            **_timed("library_ms", r["lfn"], r.get("passes", 1)),
            "library": r["library"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": r["bytes"], "operations": r["ops"], "bytes_ms": t_bytes,
            "ops_ms": t_ops, "per_step": r["per_step"],
            "per_step_ad": r["per_step_ad"],
            "ptxas": ptxas_of(r["kernel"], r["instance"]),
        }
        row.update(_ratios(row))
        if r["after"] is not None:
            row.update(r["after"](row))
        emit(row)
        require(err <= tol, f"{r['layer']}: kernel disagrees with its plain "
                            f"version: max abs err {err} > {tol}")
        results.append(row)
    return results


def train_zone_per_step(rows, key="per_step", want=LAUNCHES_PER_TRAIN_STEP,
                        phase="train_zone_per_step"):
    """Each kernel's share of one b16 train step: the rows' times
    weighted by their launches per step (``key``: their multiplicity on
    the default train path, or with fused_train_deconv), beside the
    same sums of bound, plain and library times."""
    out = {}
    for r in rows:
        n = r.get(key, 0)
        if not n:
            continue
        k = out.setdefault(r["kernel"], {"launches": 0, "ms": 0.0,
                                         "plain_ms": 0.0, "library_ms": 0.0,
                                         "bound_ms": 0.0})
        k["launches"] += n
        for field in ("ms", "plain_ms", "library_ms", "bound_ms"):
            k[field] += n * r[field]
    require({k: v["launches"] for k, v in out.items()} == want,
            f"per-step rows {out} != {want}")
    return {"phase": phase, "kernels": out,
            "ms": sum(v["ms"] for v in out.values()),
            "bound_ms": sum(v["bound_ms"] for v in out.values())}


def _row_sums(mine):
    """A kernel's times summed over its rows ``mine``: ms, plain, bound
    (and what bounds the sum), library (None if a row has none)."""
    t_bytes = sum(r["bytes_ms"] for r in mine)
    t_ops = sum(r["ops_ms"] for r in mine)
    lib = [r["library_ms"] for r in mine]
    out = {"ms": sum(r["ms"] for r in mine),
           "plain_ms": sum(r["plain_ms"] for r in mine),
           "bound_ms": sum(r["bound_ms"] for r in mine),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": None if None in lib else sum(lib)}
    out.update(_ratios(out))
    return out


def kernels_line(rows, launches_by_path):
    """One entry per kernel: its launches on every path; its times
    summed over its rows at the main cell (b16 512x512), and under
    ``at_shapes`` the same sums at each other cell its rows ran at
    (the wholeview shapes); the largest error over all its rows."""
    out = []
    for name, (src, replaces, kernels, _) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] in kernels]
        main = [r for r in mine if r["cell"] == MAIN_CELL]
        by_path = {path: sum(counts[k] for k in kernels)
                   for path, counts in launches_by_path.items()}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(r["max_abs_err"] for r in mine),
                 **_row_sums(main), "layers": [r["layer"] for r in main]}
        cells = sorted({r["cell"] for r in mine} - {MAIN_CELL})
        if cells:
            entry["at_shapes"] = {c: _row_sums([r for r in mine
                                                if r["cell"] == c])
                                  for c in cells}
        out.append(entry)
    return {"kernels": out}


def stage_breakdown(model, x, reps=5):
    """Device ms per forward of each top-level stage (with an ASPP model
    also each ASPP and its recompression), from CUDA events recorded by
    forward hooks; ``stem pool`` is the gap between the stem conv and
    enc1, ``rest`` the forward's remainder (log-softmax), ``between
    stages`` the time no hook brackets."""
    import torch

    stages = [("stem conv", model.conv1)]
    stages += [(f"enc{i + 1}", m) for i, m in enumerate(model.enc)]
    for i, (a, c) in enumerate(zip(getattr(model, "aspp", ()),
                                   getattr(model, "combine", ()))):
        stages += [(f"aspp{i + 3}", a), (f"aspp{i + 3}_post", c)]
    depth = len(model.dec)
    stages += [(f"dec{depth - i}", m) for i, m in enumerate(model.dec)]
    stages += [("head conv10", model.conv10), ("classifier conv11", model.conv11)]
    marks = []

    def mark(tag):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((tag, ev))

    hooks = []
    for name, mod in stages:
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, n=name: mark((n, 0))))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, n=name: mark((n, 1))))
    ms = {name: 0.0 for name, _ in stages}
    ms["stem pool"] = ms["rest"] = total = 0.0
    with torch.inference_mode():
        model(x)  # warm-up
        for _ in range(reps):
            marks.clear()
            mark(("forward", 0))
            model(x)
            mark(("forward", 1))
            torch.cuda.synchronize()
            ev = dict(marks)
            for name, _ in stages:
                ms[name] += ev[(name, 0)].elapsed_time(ev[(name, 1)])
            ms["stem pool"] += ev[("stem conv", 1)].elapsed_time(ev[("enc1", 0)])
            ms["rest"] += ev[("classifier conv11", 1)].elapsed_time(
                ev[("forward", 1)])
            total += ev[("forward", 0)].elapsed_time(ev[("forward", 1)])
    for h in hooks:
        h.remove()
    out = {k: v / reps for k, v in ms.items()}
    out["total"] = total / reps
    # what no hook brackets: the skip joins (ASPP's widening concats)
    out["between stages"] = out["total"] - sum(
        v for k, v in out.items() if k != "total")
    return out


def main_path(dev, card, work):
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy.weights import (
        random_state_dict,
        save_reference_checkpoint,
    )
    from ubresnet_tpu_torch.models import get_model

    src, out, tar = (os.path.join(work, f) for f in
                     ("crops.uevt", "scores.uevt", "weights.tar"))
    t0 = time.time()
    make_synthetic_file(src, n_events=EVENTS, hw=HW, seed=0)
    sd = random_state_dict(seed=0)
    save_reference_checkpoint(sd, tar)
    setup_s = time.time() - t0

    def run_cli():
        printed = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli(["-i", src, "-o", out, "-c", tar, "-b", str(BATCH_MAIN),
                      "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        require(rc == 0, f"CLI returned {rc}")
        return wall, json.loads(printed.getvalue().strip().splitlines()[-1])

    ops.reset_launch_counts()
    wall, timing = run_cli()
    launches = ops.launch_counts()
    batches = -(-EVENTS // BATCH_MAIN)
    want = {k: LAUNCHES_PER_BATCH.get(k, 0) * batches for k in launches}
    require(launches == want, f"launch counts {launches} != {want}")

    worst = _check_scores(out, EVENTS, "uburn_plane2", HW)

    # the same job again in this process: model build, first cuDNN calls
    # and pinned buffers no longer first-time costs
    wall_warm, timing_warm = run_cli()

    # forward-only rate at batch 16, and argmax agreement on that batch
    inp = EventFileReader(src)
    crops = np.stack([inp.read_entry(i, producers=["wire"])["wire"][0].pixels
                      for i in range(BATCH_MAIN)])[..., None]
    x = torch.from_numpy(crops).to(dev)
    model = get_model("uresnet", sd, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        profile = forward_profile(lambda: model(x), fwd_ms)
        fused = model(x).argmax(-1)
        plain = get_model("uresnet", sd, policy=Policy.f32(), device=dev)
        ref = plain(x).argmax(-1)
    agree = float((fused == ref).float().mean())
    result = {
        "phase": "main_path", "card": card, "events": EVENTS,
        "batch": BATCH_MAIN, "hw": list(HW), "setup_s": setup_s,
        "cli_wall_s": wall, "crops_per_s_file_to_file": EVENTS / wall,
        "cli_wall_s_warm": wall_warm,
        "crops_per_s_file_to_file_warm": EVENTS / wall_warm,
        "forward_ms_b16": fwd_ms,
        "crops_per_s_forward_b16": BATCH_MAIN / fwd_ms * 1e3,
        "stage_ms_b16": stages, "profile_b16": profile,
        "argmax_agreement_b16_vs_f32": agree, "score_sum_max_dev": worst,
        "launches": launches, "timing": timing, "timing_warm": timing_warm,
        "crops_per_s_runner": EVENTS / timing["total"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(result)
    require(agree >= 0.99, f"kernel path vs f32 argmax agreement {agree}")
    return launches, fwd_ms


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper the eval model calls to its plain
    PyTorch version (on the card too): the model's plain path, for
    holding the kernel path against it."""
    from ubresnet_tpu_torch.ops import block, conv, deconv, pool

    swaps = [(conv, "conv_bn_act", conv.conv_bn_act_plain),
             (conv, "conv_bn_act_s8", conv.conv_bn_act_s8_plain),
             (block, "basic_block", block.basic_block_plain),
             (block, "basic_block_s8", block.basic_block_s8_plain),
             (deconv, "deconv2x", deconv.deconv2x_plain),
             (deconv, "deconv2x_s8", deconv.deconv2x_s8_plain),
             (pool, "maxpool3x3s2", pool.maxpool3x3s2_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def int8_path(dev, card, work):
    """int8 precropped deploy: the deploy smoke's 64 crops and weights
    through the CLI with --int8 (calibrated on the first 32 crops, -b
    16, cuda): 11 launches per batch, 9 of them int8; score sums. Then on
    the first 16 crops with the CLI's calibration: the int8 kernel path
    against the int8 plain path (same scales; gate: argmax ≥ 0.99), the
    int8 and bf16 forward ms at b16, the int8 stage breakdown, and —
    reported, not gated (random weights) — mean|Δp| and argmax agreement
    against the f32 path for abs-max and percentile-99.9 scales."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.quant import calibrate

    src, out, tar = (os.path.join(work, f) for f in
                     ("crops.uevt", "scores_int8.uevt", "weights.tar"))
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = cli(["-i", src, "-o", out, "-c", tar, "-b", str(BATCH_MAIN),
                  "--int8", "--int8-calib", str(INT8_CALIB), "-v",
                  "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    require(rc == 0, f"int8 CLI returned {rc}")
    lines = printed.getvalue().strip().splitlines()
    require(f"int8: calibrated on {INT8_CALIB} images" in lines,
            f"int8 CLI did not calibrate on {INT8_CALIB} images: {lines[:3]}")
    timing = json.loads(lines[-1])
    batches = -(-EVENTS // BATCH_MAIN)
    want = {k: LAUNCHES_PER_BATCH_INT8.get(k, 0) * batches for k in launches}
    require(launches == want, f"int8 launch counts {launches} != {want}")

    worst = _check_scores(out, EVENTS, "uburn_plane2", HW)

    sd, _ = load_reference_checkpoint(tar)
    inp = EventFileReader(src)
    x = torch.from_numpy(np.stack(
        [inp.read_entry(i, producers=["wire"])["wire"][0].pixels
         for i in range(BATCH_MAIN)])[..., None]).to(dev)
    model = get_model("uresnet", sd, policy=Policy.int8(), device=dev)
    runner = PrecroppedRunner(model, batch_size=BATCH_MAIN)
    t0 = time.time()
    runner.calibrate_from(src, n_images=INT8_CALIB)
    torch.cuda.synchronize()
    calib_s = time.time() - t0
    bf16 = get_model("uresnet", sd, device=dev)
    with torch.inference_mode():
        int8_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        bf16_ms = time_ms(lambda: bf16(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        profile_int8 = forward_profile(lambda: model(x), int8_ms)
        lp_kernel = model(x)
        with plain_kernels():
            lp_plain = model(x)
        lp_f32 = get_model("uresnet", sd, policy=Policy.f32(), device=dev)(x)
    p_f32 = lp_f32.exp()
    agree_plain = float((lp_kernel.argmax(-1) == lp_plain.argmax(-1))
                        .float().mean())

    def vs_f32(lp):
        return {"mean_abs_dp": float((lp.exp() - p_f32).abs().mean()),
                "argmax_agreement": float((lp.argmax(-1) == lp_f32.argmax(-1))
                                          .float().mean())}

    accuracy = {"absmax": vs_f32(lp_kernel)}
    crops = np.stack([inp.read_entry(i, producers=["wire"])["wire"][0].pixels
                      for i in range(INT8_CALIB)])[..., None]
    model.set_quant_scales(calibrate(model, [crops], percentile=99.9))
    with torch.inference_mode():
        accuracy["percentile_99.9"] = vs_f32(model(x))
    result = {
        "phase": "int8", "card": card, "events": EVENTS, "batch": BATCH_MAIN,
        "hw": list(HW), "calib_images": INT8_CALIB, "cli_wall_s": wall,
        "crops_per_s_file_to_file": EVENTS / wall, "timing": timing,
        "calibrate_s_api": calib_s, "launches": launches,
        "score_sum_max_dev": worst,
        "forward_ms_b16_int8": int8_ms, "forward_ms_b16_bf16": bf16_ms,
        "int8_over_bf16_forward": int8_ms / bf16_ms,
        "crops_per_s_forward_b16_int8": BATCH_MAIN / int8_ms * 1e3,
        "stage_ms_b16_int8": stages, "profile_b16_int8": profile_int8,
        "argmax_agreement_kernel_vs_plain_int8": agree_plain,
        "max_abs_dlogprob_kernel_vs_plain_int8": float(
            (lp_kernel - lp_plain).abs().max()),
        "vs_f32_not_gated": accuracy,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(result)
    require(agree_plain >= 0.99, f"int8 kernel path vs int8 plain path "
                                 f"argmax agreement {agree_plain}")
    return launches


def _check_scores(path, n, producer, hw, dtype=None, classes=3):
    """Every event of ``path`` (.uevt or larcv .root) carries ``classes``
    finite ``producer`` score images of ``hw`` (stored as ``dtype`` when
    given) summing to 1 ± 1e-2; returns the largest deviation of a
    sum."""
    import numpy as np

    from ubresnet_tpu_torch.data.rootio import open_event_file

    reader = open_event_file(path)
    require(len(reader) == n, f"{path}: {len(reader)} events written")
    worst = 0.0
    for i in range(n):
        imgs = reader.read_entry(i).get(producer, [])
        require(len(imgs) == classes,
                f"event {i}: {len(imgs)} {producer} images")
        require(dtype is None or all(im.pixels.dtype == dtype for im in imgs),
                f"event {i}: {producer} stored as {imgs[0].pixels.dtype}")
        s = np.stack([im.pixels for im in imgs], -1).astype(np.float32)
        require(s.shape == tuple(hw) + (classes,) and np.isfinite(s).all(),
                f"event {i}: bad scores {s.shape}")
        worst = max(worst, float(np.abs(s.sum(-1) - 1.0).max()))
    require(worst <= 1e-2, f"{path}: score sums off by {worst}")
    return worst


def _times(table, n):
    return {k: v * n for k, v in table.items()}


def _merge(*counts):
    return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def wholeview_path(dev, card, work):
    """Whole-plane deploy: WV_EVENTS synthetic 1008x3456 planes (seed 0)
    through the port's wholeview CLI (--device cuda) with the deploy
    smoke's weights: spatial (the default; first, warm, then with
    --f16-scores), --stitched, and --int8 --int8-calib 2 (spatial).
    Gates: 3 ubsnet_plane2 images per event summing to 1 ± 1e-2; exact
    launch counts (per plane 11 spatial, 11 per 10-crop chunk stitched,
    the int8 table under --int8); on one plane the kernel path against the
    plain f32 path (TF32 off), spatial and stitched, and the int8 kernel
    path against the int8 plain path on the same scales: argmax ≥ 0.99.
    Reported: planes/s, the timing dicts, forward ms per plane (spatial
    b1 1024x3456, stitched one b10 512x832 chunk, int8 spatial), the
    spatial forward's stages and profile, peak memory. Returns the
    launches of the CLI runs."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_wholeview import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import WholeViewRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.tiling import extract_tiles

    src, out, tar = (os.path.join(work, f) for f in
                     ("planes.uevt", "plane_scores.uevt", "weights.tar"))
    t0 = time.time()
    make_synthetic_file(src, n_events=WV_EVENTS, seed=0, wholeview=True)
    setup_s = time.time() - t0
    sd, _ = load_reference_checkpoint(tar)
    bf16 = get_model("uresnet", sd, device=dev)
    stitched = WholeViewRunner(bf16)  # the CLI's default tiles and chunk
    grid = stitched._grid(WV_HW)
    chunks = -(-len(grid) // stitched.crop_batch)

    def run_cli(*extra):
        printed = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli(["-i", src, "-o", out, "-c", tar, "--device", "cuda",
                      *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        require(rc == 0, f"wholeview CLI {extra} returned {rc}")
        launches = ops.launch_counts()
        sums = _check_scores(out, WV_EVENTS, "ubsnet_plane2", WV_HW)
        return {"cli_wall_s": wall, "planes_per_s_file_to_file":
                WV_EVENTS / wall, "launches": launches,
                "timing": json.loads(printed.getvalue().splitlines()[-1]),
                "score_sum_max_dev": sums,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    runs = {"spatial": run_cli(), "spatial_warm": run_cli(),
            "spatial_f16_scores": run_cli("--f16-scores"),
            "stitched": run_cli("--stitched"),
            "int8": run_cli("--int8", "--int8-calib", str(WV_CALIB))}
    want = {"spatial": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "spatial_warm": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "spatial_f16_scores": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "stitched": _times(LAUNCHES_PER_BATCH, WV_EVENTS * chunks),
            "int8": _times(LAUNCHES_PER_BATCH_INT8, WV_EVENTS)}
    for name, run in runs.items():
        got = run["launches"]
        exp = {k: want[name].get(k, 0) for k in got}
        require(got == exp, f"wholeview {name} launch counts {got} != {exp}")

    # one plane: kernel paths against plain paths
    plane = EventFileReader(src).read_entry(0, producers=["wire"])[
        "wire"][0].pixels
    f32 = get_model("uresnet", sd, policy=Policy.f32(), device=dev)
    agree = {}
    for mode, spatial in (("spatial", True), ("stitched", False)):
        k = WholeViewRunner(bf16, spatial=spatial).score_image(plane)
        p = WholeViewRunner(f32, spatial=spatial).score_image(plane)
        agree[mode] = float((k.argmax(-1) == p.argmax(-1)).mean())
    del f32
    q = get_model("uresnet", sd, policy=Policy.int8(), device=dev)
    qr = WholeViewRunner(q, spatial=True)
    n_tiles = qr.calibrate_from(src, n_images=WV_CALIB)
    kq = qr.score_image(plane)
    with plain_kernels():
        pq = qr.score_image(plane)
    agree_int8 = float((kq.argmax(-1) == pq.argmax(-1)).mean())

    # forward ms per plane: the padded plane at b1, one 10-crop chunk
    pad = np.zeros((1,) + tuple(-(-n // 32) * 32 for n in WV_HW) + (1,),
                   np.float32)
    pad[0, :WV_HW[0], :WV_HW[1], 0] = plane
    x_sp = torch.from_numpy(pad).to(dev)
    x_st = extract_tiles(x_sp[0], grid, stitched.tile_rows,
                         stitched.tile_cols)[:stitched.crop_batch]
    with torch.inference_mode():
        fwd = {"spatial_bf16": time_ms(lambda: bf16(x_sp), 1000.0),
               "stitched_bf16": chunks * time_ms(lambda: bf16(x_st),
                                                 1000.0),
               "spatial_int8": time_ms(lambda: q(x_sp), 1000.0)}
        stages = stage_breakdown(bf16, x_sp)
        profile = forward_profile(lambda: bf16(x_sp), fwd["spatial_bf16"])
        profile_st = forward_profile(lambda: bf16(x_st),
                                     fwd["stitched_bf16"] / chunks)
    result = {
        "phase": "wholeview", "card": card, "events": WV_EVENTS,
        "hw": list(WV_HW), "setup_s": setup_s, "crop_chunks": chunks,
        "runs": runs, "calib_tiles": n_tiles,
        "argmax_agreement_vs_f32": agree,
        "argmax_agreement_int8_kernel_vs_plain": agree_int8,
        "forward_ms_per_plane": fwd,
        "int8_over_bf16_spatial": fwd["spatial_int8"] / fwd["spatial_bf16"],
        "stitched_over_spatial": fwd["stitched_bf16"] / fwd["spatial_bf16"],
        "stage_ms_spatial": stages, "profile_spatial": profile,
        "profile_stitched": profile_st,
    }
    emit(result)
    for mode, a in agree.items():
        require(a >= 0.99, f"wholeview {mode}: kernel path vs f32 argmax "
                           f"agreement {a}")
    require(agree_int8 >= 0.99, f"wholeview int8 kernel path vs int8 plain "
                                f"path argmax agreement {agree_int8}")
    return _merge(*(r["launches"] for r in runs.values()))


SPATIAL_DEVICES = (2, 4)     # slabs of the spatial_devices phase's plane


def _stage_bits(model, x, dev, n_slabs):
    """Each stage of ``model``'s row-sharded forward (models/uresnet.py:
    ZoneModel.forward_rows) on its own: the whole plane's input of the
    stage split by rows over ``[dev] * R``, the stage run on every slab
    with its halo, against the stage's whole-plane output. One row a
    stage: whether it launches a kernel, and for each R the elements
    that differ and their largest difference."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.models.blocks import stem_pool, zone_active
    from ubresnet_tpu_torch.models.uresnet import ROW_HALO, zone_packs
    from ubresnet_tpu_torch.parallel.sharding import (
        halo_apply,
        row_gather,
        row_split,
    )

    pol = model.policy
    pack = zone_packs(model.config)["stem"]
    stages = []

    def stage(name, fn, halo, scale, *ins):
        before = sum(ops.launch_counts().values())
        out = fn(*ins)
        torch.cuda.synchronize()
        stages.append((name, fn, halo, scale, ins, out,
                       sum(ops.launch_counts().values()) > before))
        return out

    with torch.inference_mode(), zone_active(model.packed_zone(x.shape[2])):
        x0 = stage("stem", lambda a: model.conv1(
            a.to(pol.compute_dtype).contiguous()), ROW_HALO["stem"], "same",
            x)
        y = stage("pool", lambda a: stem_pool(a, fused=pol.fused_eval,
                                              pack=pack),
                  ROW_HALO["pool"], "down", x0)
        skips = [x0]
        for i, enc in enumerate(model.enc):
            s2 = enc.res1.stride == 2
            y = stage(f"enc{i + 1}", enc, ROW_HALO["stage_s2" if s2
                                                   else "stage"],
                      "down" if s2 else "same", y)
            skips.append(y)
        for j, (dec, skip) in enumerate(zip(model.dec,
                                            reversed(skips[:-1]))):
            up = stage(f"dec{5 - j}.deconv", lambda a, dec=dec: dec.deconv(
                a, (2 * a.shape[1], 2 * a.shape[2])), ROW_HALO["deconv"],
                "up", y)
            y = stage(f"dec{5 - j}.res", lambda u, s, dec=dec: dec.res(
                u, dual=s), ROW_HALO["stage"], "same", up, skip)
        stage("head", lambda a: model.conv11(model.conv10(a)),
              ROW_HALO["head"], "same", y)
        rows = []
        for name, fn, halo, scale, ins, want, kernel in stages:
            row = {"stage": name, "kernel": kernel}
            for r in n_slabs:
                sl = [row_split(t, [dev] * r) for t in ins]
                got = row_gather(halo_apply(lambda d, *a: fn(*a), sl[0],
                                            halo, scale, extras=sl[1:]), dev)
                row[f"R{r}_differ"] = int((got != want).sum())
                row[f"R{r}_max_abs"] = float((got.float()
                                              - want.float()).abs().max())
            rows.append(row)
    return rows


def spatial_devices_path(dev, card, work):
    """Whole planes row-sharded over several devices (the counterpart of
    the JAX package's ``spatial_mesh``): plane 0 of the wholeview phase's
    file through ``WholeViewRunner(devices=[cuda:0] * R)`` for R in
    SPATIAL_DEVICES, each against the one-device spatial plane of the
    same run, at f32 (Policy.f32, TF32 off), bf16 and int8 (calibrated
    once, WV_CALIB planes; the same model, so the same scales), with the
    deploy smoke's weights and with them "tame" (the classifier scaled by
    3e-4, as the CPU tests scale it: the seeded BN statistics blow the
    logits up to where float32 probabilities saturate).

    The zone kernels compute per pixel, so on a slab each is the whole
    plane's bit for bit; cuDNN picks its algorithm by shape, so a deep
    stage whose slabs are short rounds its bf16 sums otherwise, and the
    random network carries those last bits to the scores (int8's
    requantization turns some into whole steps). Gates: f32 (tame)
    max|Δp| <= 1e-5; every stage that launches a kernel, run alone on
    slabs of its whole-plane input, bit-equal to its output (bf16 and
    int8); bf16 and int8 argmax disagreement with the f32 plane at most
    twice the one-device plane's (train_parity's rule for bf16 against
    f32); the zone launches R x the one-device plane's; scores summing
    to 1 ± 1e-2. Reported: the agreement with the one-device plane,
    max|Δp| and differing pixels, each stage's differing elements, the
    bf16 plane's forward ms at R = 1, 2, 4 on the one card, the halo
    rows and bytes a plane. Returns the launches of the row-sharded
    planes."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import WholeViewRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.parallel.sharding import row_gather, row_split

    t_phase = time.time()
    src, tar = (os.path.join(work, f) for f in ("planes.uevt", "weights.tar"))
    deploy, _ = load_reference_checkpoint(tar)
    tame = dict(deploy, **{"conv11.weight": deploy["conv11.weight"] * 3e-4})
    plane = EventFileReader(src).read_entry(0, producers=["wire"])[
        "wire"][0].pixels
    pad = np.zeros((1,) + tuple(-(-n // 32) * 32 for n in WV_HW) + (1,),
                   np.float32)
    pad[0, :WV_HW[0], :WV_HW[1], 0] = plane
    x = torch.from_numpy(pad).to(dev)
    result = {"phase": "spatial_devices", "card": card, "hw": list(WV_HW),
              "devices": list(SPATIAL_DEVICES)}
    counts, failed = [], []
    table = {"f32": {}, "bf16": LAUNCHES_PER_BATCH,
             "int8": LAUNCHES_PER_BATCH_INT8}
    for wname, sd in (("tame", tame), ("deploy", deploy)):
        f32_want = None
        for mode, pol in (("f32", Policy.f32()), ("bf16", Policy()),
                          ("int8", Policy.int8())):
            model = get_model("uresnet", sd, policy=pol, device=dev)
            one = WholeViewRunner(model, spatial=True)
            if mode == "int8":
                one.calibrate_from(src, n_images=WV_CALIB)
            ops.reset_launch_counts()
            want = one.score_image(plane)
            one_counts = {k: v for k, v in ops.launch_counts().items() if v}
            if one_counts != table[mode]:
                failed.append(f"{wname} {mode}: one-device launches "
                              f"{one_counts}")
            res = {"launches_one_device": one_counts}
            if mode == "f32":
                f32_want = want.argmax(-1)
            else:
                res["one_device_argmax_vs_f32"] = one_f32 = float(
                    (want.argmax(-1) == f32_want).mean())
            for r in SPATIAL_DEVICES:
                runner = WholeViewRunner(model, spatial=True,
                                         devices=[dev] * r)
                ops.reset_launch_counts()
                got = runner.score_image(plane)
                got_counts = {k: v for k, v in ops.launch_counts().items()
                              if v}
                dp = float(np.abs(got - want).max())
                agree = float((got.argmax(-1) == want.argmax(-1)).mean())
                res[f"R{r}"] = row = {
                    "max_abs_dp": dp, "argmax_agreement": agree,
                    "pixels_differing": int((got != want).any(-1).sum()),
                    "score_sum_max_dev": float(np.abs(got.sum(-1)
                                                      - 1).max()),
                    "launches": got_counts, "halo": dict(runner.last_halo)}
                tag = f"{wname} {mode} R={r}"
                if mode == "f32":
                    with torch.inference_mode():
                        a = model(x, logits=True).float()
                        b = row_gather(model.forward_rows(
                            row_split(x, [dev] * r), logits=True),
                            dev).float()
                    row["logit_rel_err"] = float(
                        (a - b).abs().max() / a.abs().max())
                    if wname == "tame" and dp > 1e-5:
                        failed.append(f"{tag}: max|dp| {dp}")
                else:
                    row["argmax_vs_f32"] = r_f32 = float(
                        (got.argmax(-1) == f32_want).mean())
                    if 1 - r_f32 > 2 * (1 - one_f32):
                        failed.append(f"{tag}: argmax vs f32 {r_f32}, one "
                                      f"device {one_f32}")
                if got_counts != {k: r * v for k, v in one_counts.items()}:
                    failed.append(f"{tag}: launches {got_counts} != {r} x "
                                  f"{one_counts}")
                if row["score_sum_max_dev"] > 1e-2:
                    failed.append(f"{tag}: scores do not sum to 1")
                counts.append(got_counts)
            if mode != "f32":
                res["stages"] = _stage_bits(model, x, dev, SPATIAL_DEVICES)
                for st in res["stages"]:
                    if st["kernel"] and any(st[f"R{r}_differ"]
                                            for r in SPATIAL_DEVICES):
                        failed.append(f"{wname} {mode}: kernel stage "
                                      f"{st['stage']} differs on slabs")
            if mode == "bf16" and wname == "deploy":
                with torch.inference_mode():  # forward ms on the one card
                    res["forward_ms"] = {"R1": time_ms(lambda: model(x),
                                                       500.0)}
                    for r in SPATIAL_DEVICES:
                        res["forward_ms"][f"R{r}"] = time_ms(
                            lambda r=r: model.forward_rows(row_split(
                                x, [dev] * r)), 500.0)
            result[f"{wname}_{mode}"] = res
            del model, one
            torch.cuda.empty_cache()
    result["seconds"] = time.time() - t_phase
    emit(result)
    require(not failed, f"spatial_devices: {failed}")
    return {k: sum(c.get(k, 0) for c in counts) for k in ops.KERNELS}


def serve_path(dev, card, work):
    """The serve loop (cli/serve.py --once, --device cuda, the deploy
    smoke's weights) over two watch dirs: two precropped files of
    SERVE_CROPS 512² crops and a corrupt file (-b 16), then one
    whole-plane file of 2 events (--wholeview). Gates: the good files
    served with score sums 1 ± 1e-2, the corrupt one quarantined with
    its .failed marker, the shutdown line with the served count, exact
    launches (11 per batch, 11 per plane). Returns the launches."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.serve import main as serve
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    tar = os.path.join(work, "weights.tar")
    t0 = time.time()
    dirs = {}
    for name in ("crops", "planes"):
        for side in ("in", "out"):
            d = os.path.join(work, f"serve_{name}_{side}")
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            dirs[name, side] = d
    for i, f in enumerate(("a.uevt", "b.uevt")):
        make_synthetic_file(os.path.join(dirs["crops", "in"], f),
                            n_events=SERVE_CROPS, hw=HW, seed=10 + i)
    with open(os.path.join(dirs["crops", "in"], "broken.uevt"), "wb") as f:
        f.write(b"not an event file")
    make_synthetic_file(os.path.join(dirs["planes", "in"], "wv.uevt"),
                        n_events=2, seed=1, wholeview=True)
    setup_s = time.time() - t0

    def run(name, *extra):
        printed, errors = io.StringIO(), io.StringIO()
        ops.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(errors):
            rc = serve(["--watch-dir", dirs[name, "in"], "--out-dir",
                        dirs[name, "out"], "-c", tar, "--once",
                        "--device", "cuda", *extra])
        torch.cuda.synchronize()
        require(rc == 0, f"serve {name} returned {rc}")
        lines = [json.loads(ln) for ln in printed.getvalue().splitlines()
                 if ln.startswith("{")]
        failed = [json.loads(ln) for ln in errors.getvalue().splitlines()
                  if ln.startswith("{")]
        return {"wall_s": time.time() - t0, "lines": lines,
                "failed": failed, "launches": ops.launch_counts()}

    crops = run("crops", "-b", str(BATCH_MAIN))
    planes = run("planes", "--wholeview")
    result = {"phase": "serve", "card": card, "setup_s": setup_s,
              "crops": crops, "planes": planes}
    emit(result)
    out = dirs["crops", "out"]
    require(crops["lines"][-1] == {"shutdown": True, "served": 2},
            f"serve crops: {crops['lines']}")
    require([ln.get("served") for ln in crops["lines"][:-1]]
            == ["a.uevt", "b.uevt"], f"serve crops: {crops['lines']}")
    require([f["failed"] for f in crops["failed"]] == ["broken.uevt"]
            and os.path.exists(os.path.join(out, "broken.uevt.failed"))
            and not os.path.exists(os.path.join(out, "broken_scores.uevt")),
            f"corrupt file not quarantined: {crops['failed']}")
    for f in ("a", "b"):
        _check_scores(os.path.join(out, f"{f}_scores.uevt"), SERVE_CROPS,
                      "uburn_plane2", HW)
    require(planes["lines"][-1] == {"shutdown": True, "served": 1},
            f"serve planes: {planes['lines']}")
    _check_scores(os.path.join(dirs["planes", "out"], "wv_scores.uevt"), 2,
                  "ubsnet_plane2", WV_HW)
    batches = 2 * -(-SERVE_CROPS // BATCH_MAIN)
    for name, got, n in (("crops", crops["launches"], batches),
                         ("planes", planes["launches"], 2)):
        exp = {k: LAUNCHES_PER_BATCH.get(k, 0) * n for k in got}
        require(got == exp, f"serve {name} launch counts {got} != {exp}")
    return _merge(crops["launches"], planes["launches"])


def _run_cli(fn, argv):
    """``fn(argv)`` with its stdout and stderr captured and the kernels'
    launches counted: (rc, stdout, stderr, wall s, launches)."""
    import torch

    from ubresnet_tpu_torch import ops

    printed, errors = io.StringIO(), io.StringIO()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed), \
            contextlib.redirect_stderr(errors):
        rc = fn(argv)
    torch.cuda.synchronize()
    return (rc, printed.getvalue(), errors.getvalue(), time.time() - t0,
            ops.launch_counts())


def _agreement(path_a, path_b, producer):
    """Argmax agreement, max|Δp| and bit equality of two score files'
    ``producer`` images (any format)."""
    import numpy as np

    from ubresnet_tpu_torch.data.rootio import open_event_file

    a, b = open_event_file(path_a), open_event_file(path_b)
    agree, dp, same = [], 0.0, True
    for i in range(len(a)):
        sa, sb = (np.stack([im.pixels.astype(np.float32)
                            for im in r.read_entry(i)[producer]], -1)
                  for r in (a, b))
        agree.append(float((sa.argmax(-1) == sb.argmax(-1)).mean()))
        dp = max(dp, float(np.abs(sa - sb).max()))
        same = same and np.array_equal(sa, sb)
    return {"argmax_agreement": float(np.mean(agree)), "max_abs_dp": dp,
            "bit_equal": same}


def _root_round_trip(src, dst, producers=None):
    """``src`` (.uevt) → ``dst`` (.root) with the port's uevt_to_root
    (``producers``, or all); read back, every image's pixels, meta and
    ids must equal the source's. Returns the conversion's seconds."""
    import dataclasses

    import numpy as np

    from ubresnet_tpu_torch.data.rootio import RootEventReader, uevt_to_root
    from ubresnet_tpu_torch.data.uevt import EventFileReader

    t0 = time.time()
    n = uevt_to_root(src, dst, producers)
    seconds = time.time() - t0
    u, r = EventFileReader(src), RootEventReader(dst)
    require(n == len(u) == len(r), f"{dst}: {len(r)} of {len(u)} entries")
    for i in range(n):
        eu, er = u.read_entry(i, producers), r.read_entry(i)
        require(r.rse(i) == u.rse(i) and sorted(eu) == sorted(er),
                f"{dst} entry {i}: ids or producers differ")
        for prod, imgs in eu.items():
            for a, b in zip(imgs, er[prod], strict=True):
                require(np.array_equal(a.pixels.astype(np.float32), b.pixels)
                        and dataclasses.astuple(a.meta)
                        == dataclasses.astuple(b.meta) and a.rse == b.rse,
                        f"{dst} entry {i} {prod}: pixels, meta or ids differ")
    r.close()
    return seconds


def _remat_steps(dev):
    """train_parity's batch and weights through one Adam step without
    remat, with stage remat (Policy.remat) and with whole-forward remat
    (the step's remat): each remat step's loss and gradients against the
    no-remat step's under train_parity's gates, its BN running stats
    within 1e-6·max|stat| of them (a recompute that moved them again
    would be 10% off), its launches exactly the step table plus
    REMAT_EXTRA; then 4 more steps timed with CUDA events and their peak
    memory."""
    import dataclasses

    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    sd = random_state_dict(seed=0)
    b = {k: torch.from_numpy(v).to(dev) for k, v in _train_batch(7).items()}
    runs = {}
    for mode, stage, whole in (("none", False, False),
                               ("model_remat", True, False),
                               ("remat", False, True)):
        model = get_model("uresnet", sd, device=dev, train=True,
                          policy=dataclasses.replace(Policy(), remat=stage))
        opt = make_optimizer(model.parameters(), "adam", 1e-3,
                             weight_decay=1e-4)
        step = build_train_step(use_pallas_loss=True, remat=whole,
                                device=dev)
        state = create_train_state(model, opt)
        ops.reset_launch_counts()
        state, m = step(state, b)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        grads = {k: p.grad.float().clone()
                 for k, p in model.named_parameters()}
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        torch.cuda.reset_peak_memory_stats()
        state, losses, times = _adam_steps(step, state, b, n=4)
        runs[mode] = {"loss": m["loss"], "grads": grads, "stats": stats,
                      "launches": launches,
                      "step_ms": sum(times[1:]) / len(times[1:]),
                      "peak_mem_gib":
                          torch.cuda.max_memory_allocated() / 2 ** 30,
                      "losses": losses}
        del model, opt, state, step
        torch.cuda.empty_cache()
    ref = runs["none"]
    gsc = max(float(g.abs().max()) for g in ref["grads"].values())
    out = {"none": {k: ref[k] for k in ("loss", "step_ms", "peak_mem_gib",
                                        "launches")}}
    for mode in REMAT_EXTRA:
        r = runs[mode]
        want = {k: v + REMAT_EXTRA[mode].get(k, 0)
                for k, v in ref["launches"].items()}
        stat_err = max(float((r["stats"][k] - v).abs().max())
                       / max(float(v.abs().max()), 1e-30)
                       for k, v in ref["stats"].items())
        out[mode] = {
            "loss": r["loss"],
            "loss_rel_vs_no_remat": abs(r["loss"] - ref["loss"])
            / abs(ref["loss"]),
            "grad_err_vs_no_remat": max(
                float((r["grads"][k] - g).abs().max())
                for k, g in ref["grads"].items()) / gsc,
            "bn_stats_rel_err_vs_no_remat": stat_err,
            "launches": r["launches"], "launches_want": want,
            "step_ms": r["step_ms"], "peak_mem_gib": r["peak_mem_gib"],
            "step_ms_over_no_remat": r["step_ms"] / ref["step_ms"],
            "peak_mem_over_no_remat": r["peak_mem_gib"] / ref["peak_mem_gib"]}
    require(ref["launches"] == LAUNCHES_PER_TRAIN_STEP,
            f"train step launches {ref['launches']}")
    return out


def host_libraries():
    """Build librootio and libuevt from the port's cpp/ copies (g++,
    utils/native_build.py): the compiler, and each library's seconds
    and whether this call built it."""
    from ubresnet_tpu_torch.utils import native_build

    cxx = native_build.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    libs = {}
    for name in ("rootio", "uevt"):
        fresh = not native_build.library_path(name).exists()
        t0 = time.time()
        lib = native_build.build(name)
        libs[name] = {"seconds": time.time() - t0, "built_now": fresh,
                      "library": os.path.relpath(lib, HERE)}
    return {"compiler": cxx, "version": version, "libraries": libs}


def root_path(dev, card, work, gates, host_build):
    """larcv .root in and out through every entry point, at the main
    path's sizes and with its weights (``host_build``: the build phase's
    report of the host libraries, printed with their codecs): the
    main phase's 64 crops .uevt → .root and back (equal); precropped
    deploy .root → .root (first, warm) against .uevt → .uevt; wholeview
    .root → .root over the wholeview phase's 4 planes against .uevt;
    serve --root-out over a .root, a .uevt and a corrupt .root; the
    train CLI on a .root of the train phase's 64 events through the C++
    filler, plain, with model.remat and with remat, then --trace and
    --debug-dump; the remat steps on train_parity's batch. Returns the
    launches of the deploy and train CLI runs."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch.cli.infer_precropped import main as precropped
    from ubresnet_tpu_torch.cli.infer_wholeview import main as wholeview
    from ubresnet_tpu_torch.cli.serve import main as serve
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.data import native, rootio
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    require(rootio.native_available() and native.native_available(),
            "the host libraries do not load")
    tar = os.path.join(work, "weights.tar")
    p = {n: os.path.join(work, n) for n in (
        "crops.uevt", "crops.root", "root_scores.root", "root_scores.uevt",
        "planes.uevt", "planes.root", "plane_scores.root",
        "plane_scores.uevt", "train.uevt", "train.root")}
    t_phase = time.time()
    result = {"phase": "root", "card": card, "host_build": host_build,
              "codecs": rootio.codecs()}
    launches = []

    # 1. round trip of the main phase's crops
    result["uevt_to_root_s"] = {"crops": _root_round_trip(
        p["crops.uevt"], p["crops.root"])}

    # 2. precropped deploy, .root → .root against .uevt → .uevt
    batches = -(-EVENTS // BATCH_MAIN)
    runs = {}
    for name, src, out in (("root", "crops.root", "root_scores.root"),
                           ("root_warm", "crops.root", "root_scores.root"),
                           ("uevt_warm", "crops.uevt", "root_scores.uevt")):
        rc, text, _, wall, got = _run_cli(precropped, [
            "-i", p[src], "-o", p[out], "-c", tar, "-b", str(BATCH_MAIN),
            "--device", "cuda"])
        require(rc == 0, f"precropped {name} returned {rc}")
        want = {k: LAUNCHES_PER_BATCH.get(k, 0) * batches for k in got}
        require(got == want, f"precropped {name} launches {got} != {want}")
        launches.append(got)
        runs[name] = {"cli_wall_s": wall,
                      "crops_per_s_file_to_file": EVENTS / wall,
                      "timing": json.loads(text.strip().splitlines()[-1])}
    sums = _check_scores(p["root_scores.root"], EVENTS, "uburn_plane2", HW,
                         np.float32)
    vs = _agreement(p["root_scores.root"], p["root_scores.uevt"],
                    "uburn_plane2")
    result["precropped"] = {"runs": runs, "score_sum_max_dev": sums,
                            "root_vs_uevt": vs}
    require(vs["argmax_agreement"] >= 0.999 and vs["max_abs_dp"] <= 1e-2,
            f"precropped .root vs .uevt: {vs}")

    # 3. wholeview deploy (spatial), .root → .root against .uevt (the
    # scored producer only: the planes' labels and weights are 2/3 of
    # the bytes and no deploy reads them)
    result["uevt_to_root_s"]["planes"] = _root_round_trip(
        p["planes.uevt"], p["planes.root"], ["wire"])
    runs = {}
    for name, src, out in (("root", "planes.root", "plane_scores.root"),
                           ("uevt", "planes.uevt", "plane_scores.uevt")):
        rc, text, _, wall, got = _run_cli(wholeview, [
            "-i", p[src], "-o", p[out], "-c", tar, "--device", "cuda"])
        require(rc == 0, f"wholeview {name} returned {rc}")
        want = _times(LAUNCHES_PER_BATCH, WV_EVENTS)
        want = {k: want.get(k, 0) for k in got}
        require(got == want, f"wholeview {name} launches {got} != {want}")
        launches.append(got)
        runs[name] = {"cli_wall_s": wall,
                      "planes_per_s_file_to_file": WV_EVENTS / wall,
                      "timing": json.loads(text.strip().splitlines()[-1])}
    sums = _check_scores(p["plane_scores.root"], WV_EVENTS, "ubsnet_plane2",
                         WV_HW, np.float32)
    vs = _agreement(p["plane_scores.root"], p["plane_scores.uevt"],
                    "ubsnet_plane2")
    result["wholeview"] = {"runs": runs, "score_sum_max_dev": sums,
                           "root_vs_uevt": vs}
    require(vs["argmax_agreement"] >= 0.999 and vs["max_abs_dp"] <= 1e-2,
            f"wholeview .root vs .uevt: {vs}")

    # 4. serve --root-out: a .root, a .uevt and a corrupt .root
    watch, outd = (os.path.join(work, f"serve_root_{s}")
                   for s in ("in", "out"))
    for d in (watch, outd):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(watch)
    make_synthetic_file(os.path.join(work, "serve_a.uevt"),
                        n_events=SERVE_CROPS, hw=HW, seed=20)
    rootio.uevt_to_root(os.path.join(work, "serve_a.uevt"),
                        os.path.join(watch, "a.root"))
    make_synthetic_file(os.path.join(watch, "b.uevt"), n_events=SERVE_CROPS,
                        hw=HW, seed=21)
    with open(os.path.join(watch, "c.root"), "wb") as f:
        f.write(b"root" + bytes(60))
    rc, text, err, wall, got = _run_cli(serve, [
        "--watch-dir", watch, "--out-dir", outd, "-c", tar, "--once",
        "--root-out", "-b", str(BATCH_MAIN), "--device", "cuda"])
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    failed = [json.loads(ln) for ln in err.splitlines() if ln.startswith("{")]
    result["serve"] = {"wall_s": wall, "lines": lines, "failed": failed}
    require(rc == 0 and lines[-1] == {"shutdown": True, "served": 2}
            and [ln.get("served") for ln in lines[:-1]]
            == ["a.root", "b.uevt"], f"serve --root-out: {lines}")
    require([f["failed"] for f in failed] == ["c.root"]
            and os.path.exists(os.path.join(outd, "c.root.failed"))
            and not os.path.exists(os.path.join(outd, "c_scores.root")),
            f"corrupt .root not quarantined: {failed}")
    for f in ("a", "b"):
        _check_scores(os.path.join(outd, f"{f}_scores.root"), SERVE_CROPS,
                      "uburn_plane2", HW, np.float32)
    n = 2 * -(-SERVE_CROPS // BATCH_MAIN)
    want = {k: LAUNCHES_PER_BATCH.get(k, 0) * n for k in got}
    require(got == want, f"serve --root-out launches {got} != {want}")
    launches.append(got)

    # 5. training from .root through the C++ filler
    result["uevt_to_root_s"]["train"] = _root_round_trip(
        p["train.uevt"], p["train.root"])
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [p["train.root"]],
                          "batch_size": BATCH_MAIN, "native": True},
           "num_iters": TRAIN_ITERS, "print_every": 1,
           "checkpoint_every": TRAIN_ITERS, "seed": 0}
    cfg_path = os.path.join(work, "train_root.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    train = {}
    for mode, extra, iters in (
            ("plain", [], TRAIN_ITERS),
            ("model_remat", ["--set", "model.remat=true"], TRAIN_ITERS),
            ("remat", ["--set", "remat=true"], TRAIN_ITERS),
            ("trace", ["--set", f"num_iters={TRACE_ITERS}", "--trace",
                       os.path.join(work, "train_trace")], TRACE_ITERS)):
        ckpt = os.path.join(work, f"train_root_ckpt_{mode}")
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.reset_peak_memory_stats()
        rc, out, _, wall, got = _run_cli(train_cli, [
            "--config", cfg_path, "--set", f"checkpoint_dir={ckpt}",
            *extra, "--device", "cuda"])
        summary = json.loads(out[out.rfind("\n{\n") + 1:])
        losses = [float(ln.split()[3]) for ln in out.splitlines()
                  if ln.startswith("iter ")]
        step = {k: v + REMAT_EXTRA.get(mode, {}).get(k, 0)
                for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
        want = {k: step.get(k, 0) * iters for k in got}
        train[mode] = {"rc": rc, "cli_wall_s": wall, "losses": losses,
                       "loader": summary.get("loader"),
                       "final_iter": summary.get("final_iter"),
                       "launches": got,
                       "host_step_ms_mean": 1e3 * summary.get(
                           "meters", {}).get("time/step", float("nan")),
                       "peak_mem_gib":
                           torch.cuda.max_memory_allocated() / 2 ** 30}
        require(rc == 0 and "error" not in summary
                and summary["final_iter"] == iters,
                f"train from .root ({mode}) failed:\n{out}")
        require(summary["loader"] == "NativeBatchLoader",
                f"train from .root ({mode}): {summary['loader']} served")
        require(len(losses) == iters and np.isfinite(losses).all(),
                f"train from .root ({mode}): losses {losses}")
        require(got == want, f"train from .root ({mode}) launches {got} "
                             f"!= {want}")
        launches.append(got)
    trace = os.path.join(work, "train_trace", "trace.json")
    with open(trace) as f:
        text = f.read()
    named = sorted(z for z in ZONE_KERNELS if z in text)
    train["trace"].update(trace_bytes=len(text), trace_zone_kernels=named)
    require(named, f"{trace} names no zone kernel")
    dump = os.path.join(work, "train_dump")
    shutil.rmtree(dump, ignore_errors=True)
    rc, out, _, _, _ = _run_cli(train_cli, ["--config", cfg_path,
                                            "--debug-dump", dump])
    pngs = sorted(os.listdir(dump)) if os.path.isdir(dump) else []
    want = sorted(f"{k}_{i}.png" for k in ("adc", "label", "weight")
                  for i in range(BATCH_MAIN))
    train["debug_dump_pngs"] = len(pngs)
    require(rc == 0 and pngs == want, f"--debug-dump wrote {pngs}")
    for name in pngs:
        with open(os.path.join(dump, name), "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name}: not a PNG")
    result["train"] = train
    remat = _remat_steps(dev)
    result.update(remat_steps=remat, seconds=time.time() - t_phase)
    emit(result)
    for mode in REMAT_EXTRA:
        r = remat[mode]
        require(r["loss_rel_vs_no_remat"] <= gates["loss_rel_vs_f32"]
                and r["grad_err_vs_no_remat"] <= gates["grad_err_vs_f32"],
                f"{mode} step vs no remat: {r}")
        require(r["bn_stats_rel_err_vs_no_remat"] <= 1e-6,
                f"{mode}: BN running stats moved off the no-remat step's "
                f"({r['bn_stats_rel_err_vs_no_remat']})")
        require(r["launches"] == r["launches_want"],
                f"{mode} step launches {r['launches']} != "
                f"{r['launches_want']}")
    return _merge(*launches)


def _train_batch(seed, hw=HW, classes=3):
    """One seeded batch of 16 synthetic events of ``hw`` (image, label,
    weight), as the loader assembles it; with 4 classes every other
    track pixel (in raster order) is labelled 3."""
    import numpy as np

    from ubresnet_tpu_torch.data.synthetic import synth_event

    rng = np.random.RandomState(seed)
    evs = [synth_event(rng, hw) for _ in range(BATCH_MAIN)]
    label = np.stack([e["segment"] for e in evs]).astype(np.int32)
    if classes == 4:
        odd = (np.arange(label.size) % 2).reshape(label.shape) == 1
        label[(label == 1) & odd] = 3
    return {"image": np.stack([e["wire"] for e in evs])[..., None],
            "label": label, "weight": np.stack([e["weight"] for e in evs])}


ZONE_KERNELS = ("conv_stats_kernel", "conv_dw_kernel", "conv_bn_act_kernel",
                "nll_fwd_kernel", "nll_bwd_kernel", "maxpool3x3s2_kernel",
                "sum_rows_kernel", "deconv2x_kernel", "conv_s2k4_kernel",
                "deconv_dw_kernel", "deconv2x_bwd_kernel")


def step_profile(step, state, batch, step_ms, steps=2, detail=()):
    """Device time of ``steps`` train steps by kernel (torch.profiler):
    the train zone's kernels (ops/csrc) against everything else, the
    busy share of the CUDA-event step time, the largest other kernels
    and the per-step time of each kernel named in ``detail``. None of it
    gates; if the profiler sees no device time it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels, launches = _kernel_times(prof, steps)
    if not kernels:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    zone = sum(ms for k, ms in kernels.items()
               if any(z in k for z in ZONE_KERNELS))
    busy = sum(kernels.values())
    others = sorted(((ms, k[:90]) for k, ms in kernels.items()
                     if not any(z in k for z in ZONE_KERNELS)), reverse=True)
    mine = {d: sum(ms for k, ms in kernels.items() if d in k)
            for d in detail}
    return {"device_busy_ms_per_step": busy, "zone_kernel_ms_per_step": zone,
            "kernel_ms_per_step": mine,
            "other_kernel_ms_per_step": busy - zone,
            "zone_share_of_step": zone / step_ms,
            "idle_share_of_step": max(0.0, 1 - busy / step_ms),
            "kernel_launches_per_step": launches,
            "top_other_kernels_ms": [[k, ms] for ms, k in others[:12]]}


def _kernel_times(prof, reps):
    """{kernel name: device ms per repetition} and launches per
    repetition from a torch.profiler run of ``reps`` repetitions."""
    import torch

    def is_kernel(e):  # device work, not a range annotated around it
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer."))

    kernels, launches = {}, 0
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / reps
        launches += e.count
    return kernels, launches / reps


def forward_profile(fn, fwd_ms, reps=3):
    """Device time of ``reps`` forwards by kernel (torch.profiler): the
    busy and idle shares of the CUDA-event forward time and the largest
    kernels. Reported, not gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, launches = _kernel_times(prof, reps)
    if not kernels:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    busy = sum(kernels.values())
    top = sorted(((ms, k[:90]) for k, ms in kernels.items()), reverse=True)
    return {"device_busy_ms_per_forward": busy,
            "idle_share_of_forward": max(0.0, 1 - busy / fwd_ms),
            "kernel_launches_per_forward": launches,
            "top_kernels_ms": [[k, ms] for ms, k in top[:16]]}


def _adam_steps(step, state, b, n=5):
    """``n`` train steps on one batch, each timed with CUDA events:
    (state, losses, ms per step)."""
    import torch

    losses, times = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        end.synchronize()
        losses.append(m["loss"])
        times.append(start.elapsed_time(end))
    return state, losses, times


def _loss_grads(sd, pol, b, dev, arch="uresnet"):
    """Loss and parameter gradients (f32 copies) of one train-mode
    forward and backward of ``sd`` (an ``arch`` model) under ``pol`` on
    batch ``b``: the loss kernel where the train zone is on, as the
    trainer runs it."""
    import torch

    from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.loss import weighted_nll

    model = get_model(arch, sd, policy=pol, device=dev, train=True)
    logits = model(b["image"], logits=True)
    if pol.fused_train:
        loss = weighted_nll(logits, b["label"], b["weight"])
    else:
        loss = pixelwise_weighted_nll_from_logits(logits, b["label"],
                                                  b["weight"])
    loss.backward()
    out = (loss.item(), {k: p.grad.float().clone()
                         for k, p in model.named_parameters()})
    del model, logits, loss
    torch.cuda.empty_cache()
    return out


def _vs_f32(loss, grads, ref):
    """A path's loss and max|Δgrad|/max|grad| from the f32 path's
    (``ref``), with the worst parameter and the median."""
    import numpy as np

    l32, g32, gsc = ref["loss_f32"], ref["grads_f32"], ref["grad_scale"]
    per = {k: float((grads[k] - g32[k]).abs().max()) / gsc for k in g32}
    worst = max(per, key=per.get)
    return {"loss": loss, "loss_rel_vs_f32": abs(loss - l32) / abs(l32),
            "grad_err_vs_f32": per[worst], "worst_param": worst,
            "grad_err_median_vs_f32": float(np.median(list(per.values())))}


def train_parity(dev, card, arch="uresnet", phase="train_parity", sd=None,
                 batch=None, want_step=LAUNCHES_PER_TRAIN_STEP):
    """Loss and gradients of the train kernel path of ``arch`` (seeded
    random weights, or ``sd``) against the plain bf16 and f32 paths on
    one batch (default: seeded 512² crops), then 5 Adam steps whose
    launches must be exactly the step table's (``want_step``). Returns
    what ``train_deconv`` holds its path against: the plain paths'
    results and gates, this path's step ms and the Adam steps'
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    if sd is None:
        sd = random_state_dict(seed=0, arch=arch)
    if batch is None:
        batch = _train_batch(7)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    hw = list(batch["image"].shape[1:3])
    kernel_pol = Policy()
    paths = {"kernel_bf16": kernel_pol,
             "plain_bf16": dataclasses.replace(kernel_pol, fused_train=False),
             "plain_f32": Policy.f32()}
    res = {name: _loss_grads(sd, pol, b, dev, arch)
           for name, pol in paths.items()}
    l32, g32 = res["plain_f32"]
    gsc = max(float(g.abs().max()) for g in g32.values())
    ref = {"loss_f32": l32, "grads_f32": g32, "grad_scale": gsc}
    kern = _vs_f32(*res["kernel_bf16"], ref)
    plain = _vs_f32(*res["plain_bf16"], ref)
    lk, gk = res["kernel_bf16"]
    lp, gp = res["plain_bf16"]
    kp = max(float((gk[k] - gp[k]).abs().max()) for k in gk) / gsc
    loss_gate = max(2 * plain["loss_rel_vs_f32"], 1e-3)
    grad_gate = max(2 * plain["grad_err_vs_f32"], 1e-2)
    result = {"phase": phase, "card": card, "batch": BATCH_MAIN,
              "hw": hw, "loss_f32": l32, "grad_scale_f32": gsc,
              "kernel_bf16": kern, "plain_bf16": plain,
              "kernel_vs_plain_bf16": {
                  "loss_rel": abs(lk - lp) / abs(lp), "grad_err": kp},
              "gates": {"loss_rel_vs_f32": loss_gate,
                        "grad_err_vs_f32": grad_gate}}
    ref.update(plain_bf16=plain, gates=result["gates"])
    del res, gk, gp
    torch.cuda.empty_cache()

    # 5 Adam steps on the batch: the loss must fall; steps 2-5 timed
    model = get_model(arch, sd, policy=kernel_pol, device=dev, train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    step = build_train_step(use_pallas_loss=True, device=dev)
    state = create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, times = _adam_steps(step, state, b)
    launches = ops.launch_counts()
    want = {k: 5 * want_step.get(k, 0) for k in launches}
    step_ms = sum(times[1:]) / len(times[1:])
    result.update({"launches": launches, "launches_want": want,
                   "adam_losses": losses, "adam_step_ms": times,
                   "train_step_ms_b16": step_ms,
                   "train_crops_per_s_b16": BATCH_MAIN / step_ms * 1e3,
                   "train_peak_mem_gib":
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                   "step_profile": step_profile(step, state, b, step_ms)})
    emit(result)
    require(kern["loss_rel_vs_f32"] <= loss_gate,
            f"kernel path loss {kern['loss_rel_vs_f32']} from f32 > "
            f"{loss_gate}")
    require(kern["grad_err_vs_f32"] <= grad_gate,
            f"kernel path grads {kern['grad_err_vs_f32']} from f32 > "
            f"{grad_gate}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"5 Adam steps did not lower the loss: {losses}")
    require(launches == want, f"{phase} launch counts {launches} != {want}")
    ref.update(step_ms=step_ms, launches=launches)
    return ref


DECONV_KERNELS = ("deconv2x_kernel", "deconv2x_bwd_kernel")


def train_deconv(dev, card, ref, rows, phase="train_deconv", sd=None,
                 want_step=LAUNCHES_PER_DECONV_STEP, cell=MAIN_CELL):
    """train_parity's batch and weights (default: the flagship's seeded
    ones, or ``sd``) through the train step with
    Policy.fused_train_deconv: loss and gradients against the plain
    paths ``ref`` holds, under train_parity's gates; then 5 Adam steps
    with exact launch counts (``want_step`` a step; the main path of
    this configuration, counted from 0 just before them). Also reported:
    deconv2x_ad's forward + backward against cuDNN's (F.conv_transpose2d
    + autograd, bf16) from this run's kernel ``rows`` at ``cell``.
    Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    if sd is None:
        sd = random_state_dict(seed=0)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in _train_batch(7).items()}
    pol = dataclasses.replace(Policy(), fused_train_deconv=True)
    kern = _vs_f32(*_loss_grads(sd, pol, b, dev), ref)
    model = get_model("uresnet", sd, policy=pol, device=dev, train=True)
    require(sum(getattr(m, "ad", False) for m in model.modules()) == 2,
            "fused_train_deconv routes other than dec2 and dec1")
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    step = build_train_step(use_pallas_loss=True, device=dev)
    state = create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, times = _adam_steps(step, state, b)
    launches = ops.launch_counts()
    want = {k: 5 * want_step.get(k, 0) for k in launches}
    step_ms = sum(times[1:]) / len(times[1:])
    gates = ref["gates"]
    ad = [r for r in rows
          if r["kernel"] == "deconv2x_ad" and r.get("cell", MAIN_CELL) == cell]
    ad_ms = sum(r["ms"] for r in ad)
    cudnn_ms = sum(r["library_ms"] for r in ad)
    result = {"phase": phase, "card": card, "batch": BATCH_MAIN,
              "hw": list(HW), "kernel_bf16_deconv_ad": kern,
              "plain_bf16": ref["plain_bf16"], "gates": gates,
              "launches": launches, "launches_want": want,
              "adam_losses": losses, "adam_step_ms": times,
              "train_step_ms_b16": step_ms,
              "train_step_ms_b16_default_zone": ref["step_ms"],
              "deconv2x_ad_fwd_bwd_ms": ad_ms,
              "cudnn_fwd_bwd_ms": cudnn_ms,
              "deconv2x_ad_over_cudnn": ad_ms / cudnn_ms,
              "train_crops_per_s_b16": BATCH_MAIN / step_ms * 1e3,
              "train_peak_mem_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "step_profile": step_profile(step, state, b, step_ms,
                                           detail=DECONV_KERNELS)}
    emit(result)
    require(kern["loss_rel_vs_f32"] <= gates["loss_rel_vs_f32"],
            f"deconv-AD path loss {kern['loss_rel_vs_f32']} from f32 > "
            f"{gates['loss_rel_vs_f32']}")
    require(kern["grad_err_vs_f32"] <= gates["grad_err_vs_f32"],
            f"deconv-AD path grads {kern['grad_err_vs_f32']} from f32 > "
            f"{gates['grad_err_vs_f32']}")
    require(launches == want, f"deconv-AD launch counts {launches} != {want}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"5 Adam steps did not lower the loss: {losses}")
    return launches


def train_path(dev, card, work):
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model

    data = os.path.join(work, "train.uevt")
    ckpt = os.path.join(work, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.time()
    make_synthetic_file(data, n_events=EVENTS, hw=HW, seed=1)
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": TRAIN_ITERS, "print_every": 1,
           "valid_every": VALID_EVERY, "valid_batches": 1,
           "checkpoint_every": 4, "checkpoint_dir": ckpt, "seed": 0}
    cfg_path = os.path.join(work, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    setup_s = time.time() - t0

    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = train_cli(["--config", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    out = printed.getvalue()
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    valid_forwards = TRAIN_ITERS // VALID_EVERY
    want = {k: (LAUNCHES_PER_TRAIN_STEP.get(k, 0) * TRAIN_ITERS
                + LAUNCHES_PER_BATCH.get(k, 0) * valid_forwards)
            for k in launches}

    final = summary.get("final_checkpoint")
    sums_dev = None
    if final and os.path.exists(final):
        sd, _ = load_reference_checkpoint(final)
        crop = _train_batch(11)["image"][:1]
        with torch.inference_mode():
            lp = get_model("uresnet", sd, device=dev)(
                torch.from_numpy(crop).to(dev))
        sums_dev = float((lp.exp().sum(-1) - 1).abs().max())
    step_s = summary.get("meters", {}).get("time/step")
    result = {"phase": "train", "card": card, "events": EVENTS,
              "batch": BATCH_MAIN, "hw": list(HW), "iters": TRAIN_ITERS,
              "rc": rc, "setup_s": setup_s, "cli_wall_s": wall,
              "losses": losses, "final_iter": summary.get("final_iter"),
              "loader": summary.get("loader"),
              "launches": launches, "launches_want": want,
              "host_step_ms_mean": step_s * 1e3 if step_s else None,
              "meters": summary.get("meters"),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "final_tar_prob_sum_max_dev": sums_dev}
    emit(result)
    require(rc == 0 and "error" not in summary, f"train CLI failed:\n{out}")
    require(summary["final_iter"] == TRAIN_ITERS,
            f"final_iter {summary['final_iter']}")
    require(len(losses) == TRAIN_ITERS and np.isfinite(losses).all(),
            f"losses {losses}")
    require(launches == want, f"train launch counts {launches} != {want}")
    require(sums_dev is not None and sums_dev <= 1e-2,
            f"final .tar scores: probability sums off by {sums_dev}")
    return launches


def qat_path(dev, card, work):
    """int8 QAT through the training CLI (--set model.qat=true) on the
    train phase's 64 events: 4 iterations and one validation, exact
    launch counts, finite losses, a final .tar that scores; then the
    int8 ladder tool at 512², reported. Returns the CLI's launches."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.tools import int8_ladder

    data = os.path.join(work, "train.uevt")  # written by train_path
    ckpt = os.path.join(work, "qat_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-4},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": QAT_ITERS, "print_every": 1,
           "valid_every": QAT_ITERS, "valid_batches": 1,
           "checkpoint_every": QAT_ITERS, "checkpoint_dir": ckpt, "seed": 2}
    cfg_path = os.path.join(work, "qat.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = train_cli(["--config", cfg_path, "--set", "model.qat=true",
                        "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    out = printed.getvalue()
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    want = {k: (LAUNCHES_PER_TRAIN_STEP.get(k, 0) * QAT_ITERS
                + LAUNCHES_PER_QAT_VALID.get(k, 0)) for k in launches}
    final = summary.get("final_checkpoint")
    sums_dev = None
    if final and os.path.exists(final):
        sd, _ = load_reference_checkpoint(final)
        crop = _train_batch(11)["image"][:1]
        with torch.inference_mode():
            lp = get_model("uresnet", sd, device=dev)(
                torch.from_numpy(crop).to(dev))
        sums_dev = float((lp.exp().sum(-1) - 1).abs().max())
    step_s = summary.get("meters", {}).get("time/step")
    result = {"phase": "qat", "card": card, "events": EVENTS,
              "batch": BATCH_MAIN, "hw": list(HW), "iters": QAT_ITERS,
              "rc": rc, "cli_wall_s": wall, "losses": losses,
              "final_iter": summary.get("final_iter"),
              "launches": launches, "launches_want": want,
              "host_step_ms_mean": step_s * 1e3 if step_s else None,
              "meters": summary.get("meters"),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "final_tar_prob_sum_max_dev": sums_dev}
    emit(result)
    require(rc == 0 and "error" not in summary,
            f"QAT train CLI failed:\n{out}")
    require(summary["final_iter"] == QAT_ITERS,
            f"final_iter {summary['final_iter']}")
    require(len(losses) == QAT_ITERS and np.isfinite(losses).all(),
            f"losses {losses}")
    require(launches == want, f"QAT launch counts {launches} != {want}")
    require(sums_dev is not None and sums_dev <= 1e-2,
            f"final .tar scores: probability sums off by {sums_dev}")

    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = int8_ladder.main([str(LADDER_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    lines = printed.getvalue().strip().splitlines()
    require(rc == 0 and len(lines) == 1, f"int8 ladder printed {lines}")
    emit({"phase": "int8_ladder", "card": card, "seconds": time.time() - t0,
          "train_batch": int8_ladder.TRAIN_BATCH,
          "result_not_gated": json.loads(lines[0])})
    return launches


ASPP_WV_EVENTS = 2           # whole planes the aspp phase scores
ASPP_TRAIN_ITERS = 4         # train CLI iterations with model.name=aspp


def aspp_path(dev, card, work):
    """ASPP-ResNet (inplanes 16, branches 16, seeded random weights in a
    reference .tar) through the port's entry points, at full width and
    depth. Precropped: the main phase's 64 crops through infer_precropped
    --arch aspp_resnet -b 16 (first and warm) and with the default
    --arch (the same bytes); forward-only b16 ms, the stage breakdown
    with aspp3-5 and dec5/dec4, argmax against the f32 path (TF32 off)
    ≥ 0.99. int8: --int8 (calibrated on 32 crops), the int8 table per
    batch; mean|Δp| from f32 reported. Wholeview: 2 planes spatial, 11
    launches a plane, argmax against f32 on one plane ≥ 0.99, forward ms
    per plane. Train: ``train_parity`` with ASPP weights (its own line,
    phase ``aspp_train_parity``: the gates, 5 Adam steps, their
    launches); then the train CLI with --set model.name=aspp_resnet (4
    iterations, one validation).
    Returns the launches of the aspp, aspp_int8 and aspp_train paths."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch.cli.infer_precropped import main as precropped
    from ubresnet_tpu_torch.cli.infer_wholeview import main as wholeview
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import PrecroppedRunner, WholeViewRunner
    from ubresnet_tpu_torch.deploy.weights import (
        random_state_dict,
        save_reference_checkpoint,
    )
    from ubresnet_tpu_torch.models import get_model

    t_phase = time.time()
    src = os.path.join(work, "crops.uevt")
    planes = os.path.join(work, "aspp_planes.uevt")
    tar = os.path.join(work, "aspp.tar")
    t0 = time.time()
    sd = random_state_dict(seed=0, arch="aspp_resnet")
    save_reference_checkpoint(sd, tar)
    make_synthetic_file(planes, n_events=ASPP_WV_EVENTS, seed=0,
                        wholeview=True)
    setup_s = time.time() - t0
    batches = -(-EVENTS // BATCH_MAIN)
    result = {"phase": "aspp", "card": card, "setup_s": setup_s,
              "events": EVENTS, "batch": BATCH_MAIN, "hw": list(HW)}

    def cli(fn, argv, table, n, name):
        rc, out, err, wall, launches = _run_cli(fn, argv)
        require(rc == 0, f"aspp {name} returned {rc}:\n{err[-2000:]}")
        want = {k: table.get(k, 0) * n for k in launches}
        require(launches == want,
                f"aspp {name} launch counts {launches} != {want}")
        return {"cli_wall_s": wall,
                "timing": json.loads(out.strip().splitlines()[-1])}, launches

    # precropped: first, warm, and the default --arch on the same .tar
    outs = {m: os.path.join(work, f"aspp_scores_{m}.uevt")
            for m in ("first", "warm", "default_arch")}
    runs, counts = {}, []
    for mode, out in outs.items():
        arch = [] if mode == "default_arch" else ["--arch", "aspp_resnet"]
        runs[mode], c = cli(precropped, ["-i", src, "-o", out, "-c", tar,
                                         "-b", str(BATCH_MAIN), "--device",
                                         "cuda", *arch],
                            LAUNCHES_PER_BATCH, batches, f"precropped {mode}")
        counts.append(c)
    worst = _check_scores(outs["first"], EVENTS, "uburn_plane2", HW)
    with open(outs["first"], "rb") as f_a, \
            open(outs["default_arch"], "rb") as f_b:
        same_bytes = f_a.read() == f_b.read()
    runs["crops_per_s_file_to_file_warm"] = (
        EVENTS / runs["warm"]["cli_wall_s"])

    # forward-only at b16, the stages, argmax against f32
    inp = EventFileReader(src)
    x = torch.from_numpy(np.stack(
        [inp.read_entry(i, producers=["wire"])["wire"][0].pixels
         for i in range(BATCH_MAIN)])[..., None]).to(dev)
    model = get_model("aspp_resnet", sd, device=dev)
    f32 = get_model("aspp_resnet", sd, policy=Policy.f32(), device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        profile = forward_profile(lambda: model(x), fwd_ms)
        lp = model(x)
        lp_f32 = f32(x)
    agree = float((lp.argmax(-1) == lp_f32.argmax(-1)).float().mean())
    result.update({
        "precropped": runs, "score_sum_max_dev": worst,
        "default_arch_same_bytes": same_bytes,
        "forward_ms_b16": fwd_ms,
        "crops_per_s_forward_b16": BATCH_MAIN / fwd_ms * 1e3,
        "stage_ms_b16": stages, "profile_b16": profile,
        "argmax_agreement_b16_vs_f32": agree})

    # int8: the CLI, then the accuracy against f32 on the b16 batch
    q_run, q_counts = cli(precropped, [
        "-i", src, "-o", os.path.join(work, "aspp_scores_int8.uevt"),
        "-c", tar, "-b", str(BATCH_MAIN), "--arch", "aspp_resnet", "--int8",
        "--int8-calib", str(INT8_CALIB), "--device", "cuda"],
        LAUNCHES_PER_BATCH_INT8, batches, "int8")
    q_worst = _check_scores(os.path.join(work, "aspp_scores_int8.uevt"),
                            EVENTS, "uburn_plane2", HW)
    q = get_model("aspp_resnet", sd, policy=Policy.int8(), device=dev)
    PrecroppedRunner(q, batch_size=BATCH_MAIN).calibrate_from(
        src, n_images=INT8_CALIB)
    with torch.inference_mode():
        q_ms = time_ms(lambda: q(x), budget_ms=1000.0)
        lq = q(x)
    result["int8"] = {
        **q_run, "score_sum_max_dev": q_worst,
        "forward_ms_b16_int8": q_ms,
        "crops_per_s_forward_b16_int8": BATCH_MAIN / q_ms * 1e3,
        "vs_f32_not_gated": {
            "mean_abs_dp": float((lq.exp() - lp_f32.exp()).abs().mean()),
            "argmax_agreement": float((lq.argmax(-1) == lp_f32.argmax(-1))
                                      .float().mean())}}
    del q, lq, lp, lp_f32
    torch.cuda.empty_cache()

    # wholeview: two planes spatial, one against f32
    wv_run, wv_counts = cli(wholeview, [
        "-i", planes, "-o", os.path.join(work, "aspp_plane_scores.uevt"),
        "-c", tar, "--arch", "aspp_resnet", "--device", "cuda"],
        LAUNCHES_PER_BATCH, ASPP_WV_EVENTS, "wholeview")
    wv_worst = _check_scores(os.path.join(work, "aspp_plane_scores.uevt"),
                             ASPP_WV_EVENTS, "ubsnet_plane2", WV_HW)
    plane = EventFileReader(planes).read_entry(0, producers=["wire"])[
        "wire"][0].pixels
    k = WholeViewRunner(model, spatial=True).score_image(plane)
    p = WholeViewRunner(f32, spatial=True).score_image(plane)
    wv_agree = float((k.argmax(-1) == p.argmax(-1)).mean())
    pad = np.zeros((1,) + tuple(-(-n // 32) * 32 for n in WV_HW) + (1,),
                   np.float32)
    pad[0, :WV_HW[0], :WV_HW[1], 0] = plane
    x_sp = torch.from_numpy(pad).to(dev)
    with torch.inference_mode():
        wv_ms = time_ms(lambda: model(x_sp), budget_ms=1000.0)
        wv_stages = stage_breakdown(model, x_sp)
    result["wholeview"] = {
        **wv_run, "planes": ASPP_WV_EVENTS, "hw": list(WV_HW),
        "score_sum_max_dev": wv_worst, "argmax_agreement_vs_f32": wv_agree,
        "forward_ms_per_plane_spatial": wv_ms,
        "stage_ms_spatial": wv_stages,
        "planes_per_s_file_to_file": ASPP_WV_EVENTS / wv_run["cli_wall_s"]}
    result["seconds"] = time.time() - t_phase
    emit(result)
    require(same_bytes, "aspp: the default --arch wrote other bytes than "
                        "--arch aspp_resnet")
    require(agree >= 0.99, f"aspp kernel path vs f32 argmax agreement "
                           f"{agree}")
    require(wv_agree >= 0.99, f"aspp wholeview kernel path vs f32 argmax "
                              f"agreement {wv_agree}")
    del model, f32, x_sp
    torch.cuda.empty_cache()

    # train: train_parity's batch, gates and launch gate, 5 Adam steps
    t0 = time.time()
    adam_counts = train_parity(dev, card, "aspp_resnet",
                               "aspp_train_parity")["launches"]
    torch.cuda.empty_cache()

    # the train CLI with model.name=aspp_resnet
    data = os.path.join(work, "train.uevt")
    ckpt = os.path.join(work, "aspp_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": ASPP_TRAIN_ITERS, "print_every": 1,
           "valid_every": ASPP_TRAIN_ITERS, "valid_batches": 1,
           "checkpoint_dir": ckpt, "seed": 0}
    cfg_path = os.path.join(work, "aspp_train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    rc, out, err, wall, cli_counts = _run_cli(
        train_cli, ["--config", cfg_path, "--device", "cuda", "--set",
                    "model.name=aspp_resnet"])
    summary = json.loads(out[out.rfind("\n{\n") + 1:]) if rc == 0 else {}
    cli_losses = [float(ln.split()[3]) for ln in out.splitlines()
                  if ln.startswith("iter ")]
    cli_want = {k: (LAUNCHES_PER_TRAIN_STEP.get(k, 0) * ASPP_TRAIN_ITERS
                    + LAUNCHES_PER_BATCH.get(k, 0)) for k in cli_counts}
    emit({"phase": "aspp_train_cli", "card": card, "rc": rc,
          "cli_wall_s": wall, "iters": ASPP_TRAIN_ITERS,
          "losses": cli_losses, "final_iter": summary.get("final_iter"),
          "loader": summary.get("loader"), "launches": cli_counts,
          "launches_want": cli_want, "meters": summary.get("meters"),
          "train_seconds": time.time() - t0,
          "phase_seconds": time.time() - t_phase})
    require(rc == 0 and "error" not in summary
            and summary.get("final_iter") == ASPP_TRAIN_ITERS,
            f"aspp train CLI failed:\n{out[-2000:]}\n{err[-2000:]}")
    require(len(cli_losses) == ASPP_TRAIN_ITERS
            and np.isfinite(cli_losses).all(), f"losses {cli_losses}")
    require(cli_counts == cli_want,
            f"aspp train CLI launch counts {cli_counts} != {cli_want}")
    return {"aspp": _merge(*counts, wv_counts), "aspp_int8": q_counts,
            "aspp_train": _merge(adam_counts, cli_counts)}


DIST_ITERS = 8               # launch --distributed 1: iterations
SWEEP_ITERS, SWEEP_FAULT = 4, 2   # each sweep job's iterations, the fault


def _dist_rank(rank, out, per_rank_bn=False):
    """One rank of the distributed phase's spawned worlds (two ranks on
    the card over gloo, or one over NCCL): train_parity's weights and
    its fixed b16 batch, this rank's contiguous share, one Adam step of
    the kernel path with its launches, then 3 more steps timed with
    CUDA events and the step's collectives replayed and timed: the
    gradient all-reduce and one (2, C) all-reduce per BatchNorm forward
    and backward. ``per_rank_bn``: the negative control — every
    BatchNorm normalises with its rank's own moments (DDP's default),
    one step, untimed. Writes ``<out>/rank<r>.pt``."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.mesh import make_mesh
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.models.blocks import BatchNorm
    from ubresnet_tpu_torch.parallel import distributed
    from ubresnet_tpu_torch.parallel.sharding import (
        all_reduce_grads,
        psum,
        shard_batch,
        shard_state,
    )
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )
    from ubresnet_tpu_torch.utils.platform import resolve_device

    distributed.initialize(device="cuda")
    dev = resolve_device("cuda")
    mesh = make_mesh()
    model = get_model("uresnet", random_state_dict(seed=0), device=dev,
                      train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    state = shard_state(create_train_state(model, opt), mesh)
    if per_rank_bn:
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.data_group = None
    step = build_train_step(use_pallas_loss=True, device=dev, mesh=mesh)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in shard_batch(_train_batch(7), mesh).items()}
    ops.reset_launch_counts()
    state, m = step(state, b)
    torch.cuda.synchronize()
    res = {"backend": distributed.backend(), "device": str(dev),
           "world": distributed.process_count(), "metrics": m,
           "launches": {k: v for k, v in ops.launch_counts().items() if v},
           "grads": {k: p.grad.float().cpu()
                     for k, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    if per_rank_bn:
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        distributed.barrier("rank_done")
        distributed.shutdown()
        return
    state, _, res["step_ms"] = _adam_steps(step, state, b, n=3)

    def timed(fn, reps=5):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return sorted(out)[len(out) // 2]

    bns = [mod for mod in model.modules() if isinstance(mod, BatchNorm)]
    bufs = [torch.zeros(2, mod.weight.numel(), device=dev) for mod in bns]

    def bn_collectives():  # one forward and one backward all-reduce each
        for t in bufs + bufs:
            psum(t, mesh.group)

    res["grad_allreduce_ms"] = timed(
        lambda: all_reduce_grads(model.parameters(), mesh.group))
    res["bn_collectives_ms_per_step"] = timed(bn_collectives)
    res["bn_layers"] = len(bns)
    res["grad_bytes"] = 4 * sum(p.numel() for p in model.parameters())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier("rank_done")
    distributed.shutdown()


def _jsonl_losses(path):
    """Per-iteration train/loss values of a ScalarWriter log."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == "train/loss"]


def _summary(text):
    """The train CLI's run summary (the last JSON object it printed)."""
    return json.loads(text[text.rfind("\n{\n") + 1:])


def distributed_path(dev, card, work, gates, keep=None):
    """The multi-process layer (parallel/, core/mesh.py, cli/launch.py,
    --data-parallel) at the flagship width on the train smoke's data.
    Returns the launches of the distributed path (the NCCL rank's run,
    each gloo rank's step, the data-parallel deploy). ``keep`` takes what
    the model_axis phase compares with: the reordering bounds and the
    distance to the one-process step, the plain CLI's losses and its
    config, the step ms of two gloo ranks and of one process."""
    import dataclasses

    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as precropped
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops import _build
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    t_phase = time.time()
    root = os.path.join(work, "distributed")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=HERE)
    result = {"phase": "distributed", "card": card}
    counts = []

    def launch(args, timeout=600):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "ubresnet_tpu_torch.cli.launch", *args],
            capture_output=True, text=True, env=env, cwd=HERE,
            timeout=timeout)
        return proc.returncode, proc.stdout + proc.stderr, time.time() - t0

    # the train smoke's config without validation, one loader thread
    # (the same batches in the same order in every run), a log of every
    # loss
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [os.path.join(work, "train.uevt")],
                          "batch_size": BATCH_MAIN, "n_threads": 1},
           "num_iters": DIST_ITERS, "print_every": 1,
           "checkpoint_every": DIST_ITERS, "seed": 0}
    cfg_path = os.path.join(root, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    # 1. launch --sweep, started first: two jobs at once on a tree without
    # the kernels' stamp (they build once, under the lock); one faults and
    # resumes. The runs of 2-4 go on meanwhile (their gates are exact;
    # the timed worlds of 5 run after it, alone)
    sweep_cfg = dict(cfg, num_iters=SWEEP_ITERS,
                     checkpoint_every=SWEEP_FAULT)
    base = os.path.join(root, "sweep_base.json")
    with open(base, "w") as f:
        json.dump(sweep_cfg, f)
    spec = os.path.join(root, "sweep.json")
    with open(spec, "w") as f:
        json.dump({"base": base, "jobs": [
            {"name": "steady"},
            {"name": "flaky", "set": {"fault_at_iter": SWEEP_FAULT}}]}, f)
    stamp = _build.build_dir() / (_build.LIB_NAME + ".stamp")
    stamp.unlink()
    t_sweep = time.time()
    sweep = subprocess.Popen(
        [sys.executable, "-m", "ubresnet_tpu_torch.cli.launch", "--sweep",
         spec, "--workdir", os.path.join(root, "sweep"), "--parallel", "2",
         "--retries", "1"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE,
        start_new_session=True)

    try:
        # 2. launch --distributed 1 (NCCL) against the plain train CLI
        rc, out, err, wall, _ = _run_cli(train_cli, [
            "--config", cfg_path, "--device", "cuda", "--set",
            f"checkpoint_dir={root}/plain_ck", "--set",
            f"log_dir={root}/plain_log"])
        require(rc == 0,
                f"plain train CLI failed:\n{out[-2000:]}{err[-2000:]}")
        plain = _jsonl_losses(os.path.join(root, "plain_log", "run.jsonl"))
        rc, out, wall = launch(["--distributed", "1", "--config", cfg_path,
                                "--workdir", os.path.join(root, "nccl"),
                                "--set", f"checkpoint_dir={root}/nccl_ck",
                                "--set", f"log_dir={root}/nccl_log"])
        log = open(os.path.join(root, "nccl", "proc0.log")).read()
        require(rc == 0, f"launch --distributed 1 returned {rc}:\n"
                         f"{out[-2000:]}\n{log[-3000:]}")
        nccl = _jsonl_losses(os.path.join(root, "nccl_log", "run.jsonl"))
        rank_counts = {k: v for k, v in
                       _summary(log)["kernel_launches"].items() if v}
        want = {k: v * DIST_ITERS for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
        line = next((ln for ln in log.splitlines()
                     if ln.startswith("distributed: process")), "")
        rel = max(abs(a - b) / abs(b) for a, b in zip(nccl, plain))
        result["nccl_world1"] = {
            "wall_s": wall, "log_line": line, "losses": nccl,
            "plain_losses": plain, "loss_rel_vs_plain": rel,
            "launches": rank_counts, "launches_want": want}
        require("backend nccl" in line and "device cuda:0" in line,
                f"launch --distributed 1 log: {line!r}")
        require(len(nccl) == len(plain) == DIST_ITERS
                and np.isfinite(nccl).all(), f"losses {nccl} / {plain}")
        require(rel <= 1e-6, f"NCCL world 1 losses {nccl} != plain {plain}")
        require(rank_counts == want,
                f"NCCL rank launches {rank_counts} != {want}")
        counts.append(rank_counts)

        # 3. infer_precropped --data-parallel: the main phase's bytes
        dp_out = os.path.join(root, "scores_dp.uevt")
        rc, out, err, wall, dp_counts = _run_cli(precropped, [
            "-i", os.path.join(work, "crops.uevt"), "-o", dp_out, "-c",
            os.path.join(work, "weights.tar"), "-b", str(BATCH_MAIN),
            "--device", "cuda", "--data-parallel"])
        with open(dp_out, "rb") as a, \
                open(os.path.join(work, "scores.uevt"), "rb") as b_:
            dp_same = a.read() == b_.read()
        batches = -(-EVENTS // BATCH_MAIN)
        dp_want = {k: LAUNCHES_PER_BATCH.get(k, 0) * batches
                   for k in dp_counts}
        result["data_parallel"] = {
            "rc": rc, "wall_s": wall, "cards": torch.cuda.device_count(),
            "same_bytes": dp_same, "launches": dp_counts}
        require(rc == 0 and dp_same, f"--data-parallel: rc {rc}, same bytes "
                                     f"{dp_same}\n{err[-2000:]}")
        require(dp_counts == dp_want,
                f"--data-parallel launches {dp_counts} != {dp_want}")
        counts.append(dp_counts)
        # 4. the sweep, finished
        out, _ = sweep.communicate(timeout=900)
    finally:  # its jobs and their trainings too
        if sweep.poll() is None:
            os.killpg(sweep.pid, signal.SIGKILL)
            sweep.wait()
    rc, wall = sweep.returncode, time.time() - t_sweep
    jobs = {j: os.path.join(root, "sweep", j) for j in ("steady", "flaky")}
    logs = {j: open(os.path.join(d, "train.log")).read()
            for j, d in jobs.items()}
    flaky_launch = open(os.path.join(jobs["flaky"], "launch.log")).read()
    finals = {j: os.path.exists(os.path.join(
        d, "checkpoints", f"step_{SWEEP_ITERS:08d}.tar"))
        for j, d in jobs.items()}
    result["sweep"] = {"rc": rc, "wall_s": wall, "final_checkpoints": finals,
                       "stamp_restored": stamp.exists(),
                       "restart_logged": "restarting with resume"
                                         in flaky_launch}
    require(rc == 0 and "sweep done: exit codes [0, 0]" in out,
            f"sweep returned {rc}:\n{out[-2000:]}\n{logs}")
    require(result["sweep"]["restart_logged"] and
            f"resumed from iter {SWEEP_FAULT}" in logs["flaky"],
            f"the faulted job did not resume:\n{logs['flaky'][-3000:]}")
    require(all(finals.values()), f"final checkpoints {finals}")
    require(stamp.exists() and stamp.read_text() == _build._source_hash(),
            "the sweep's jobs did not restore the kernel build")

    # 5. two ranks on the card (gloo) and one (NCCL) against one process.
    # Two gloo ranks compute the one-process step but for the order of
    # the sums over the shards (BN moments, gradients, loss); the bf16
    # zone amplifies that order into visible distances, so each gate is
    # set from this run's own spread of reduction order alone: one
    # process on the same batch with its samples reordered (halves
    # swapped; reversed), distance to the unreordered step, x4. A
    # negative control, two ranks with per-rank BN moments, must fail
    # the BN stats and loss bounds.
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dist_workers import run_spawned

    sd = random_state_dict(seed=0)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in _train_batch(7).items()}
    nb = b["image"].shape[0]

    def one_process(pol, order=None, timed=True):
        model = get_model("uresnet", sd, policy=pol, device=dev, train=True)
        opt = make_optimizer(model.parameters(), "adam", 1e-3,
                             weight_decay=1e-4)
        step = build_train_step(use_pallas_loss=pol.fused_train, device=dev)
        init = {k: p.detach().float().cpu().clone()
                for k, p in model.named_parameters()}
        bb = b if order is None else {k: v[order] for k, v in b.items()}
        state, m = step(create_train_state(model, opt), bb)
        out = {"metrics": m, "init": init,
               "grads": {k: p.grad.float().cpu() for k, p in
                         model.named_parameters()},
               "state": {k: v.cpu() for k, v in model.state_dict().items()}}
        if timed:
            _, _, out["step_ms"] = _adam_steps(step, state, bb, n=3)
        return out

    ref = one_process(Policy())
    plain_ref = one_process(dataclasses.replace(Policy(), fused_train=False),
                            timed=False)
    half = nb // 2
    reordered = [one_process(Policy(), order=order, timed=False) for order in
                 (torch.cat([torch.arange(half, nb), torch.arange(half)]),
                  torch.arange(nb - 1, -1, -1))]
    torch.cuda.empty_cache()

    def stat_err(a, b):
        return max(float((a[k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-30)
                   for k, v in b.items()
                   if k.endswith(("running_mean", "running_var")))

    gsc = max(float(g.abs().max()) for g in ref["grads"].values())
    m1 = ref["metrics"]
    upd = sum(float((ref["state"][k] - v).abs().sum())
              for k, v in ref["init"].items())

    def distance(r):
        """r's distance to the one-process step: loss (relative),
        accuracies, gradients (of the largest |grad|), running stats (of
        each stat's largest), updated parameters (L1 of the difference
        over the L1 of the step's update)."""
        return {
            "loss_rel": abs(r["metrics"]["loss"] - m1["loss"])
            / abs(m1["loss"]),
            "acc_max_abs": max(abs(r["metrics"][k] - m1[k]) for k in m1
                               if k.startswith("acc")),
            "grad_err": max(float((r["grads"][k] - g).abs().max())
                            for k, g in ref["grads"].items()) / gsc,
            "bn_stats_rel_err": stat_err(r["state"], ref["state"]),
            "param_update_err": sum(
                float((r["state"][k] - ref["state"][k]).abs().sum())
                for k in ref["init"]) / upd}

    spread = {}
    for r in reordered:
        for k, v in distance(r).items():
            spread[k] = max(spread.get(k, 0.0), v)
    floors = {"loss_rel": 1e-6, "acc_max_abs": 1e-6, "grad_err": 1e-4,
              "bn_stats_rel_err": 1e-6, "param_update_err": 1e-5}
    bounds = {k: max(4 * v, floors[k]) for k, v in spread.items()}
    stats_gate = max(2 * stat_err(plain_ref["state"], ref["state"]), 1e-6)
    worlds = {}
    for name, n, extra in (("gloo_2_ranks", 2, ()), ("nccl_1_rank", 1, ()),
                           ("gloo_2_ranks_per_rank_bn", 2, (True,))):
        out_dir = os.path.join(root, name)
        os.makedirs(out_dir)
        t0 = time.time()
        run_spawned(_dist_rank, n, (out_dir, *extra), timeout_s=300)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
        worlds[name] = {"seconds": time.time() - t0, "ranks": ranks}
    two = worlds["gloo_2_ranks"]["ranks"]
    cmp = [dict(distance(r), backend=r["backend"], device=r["device"],
                launches=r["launches"]) for r in two]
    control = [distance(r) for r in worlds["gloo_2_ranks_per_rank_bn"]
               ["ranks"]]
    control_fails = sorted({k for c in control for k, v in c.items()
                            if v > bounds[k]})
    same = all(torch.equal(v, two[1]["state"][k])
               for k, v in two[0]["state"].items())
    one = worlds["nccl_1_rank"]["ranks"][0]
    result["two_ranks_one_card"] = {
        "vs_one_process": cmp, "replicas_bit_equal": same,
        "reorder_spread": spread, "bounds": bounds,
        "per_rank_bn_control": control,
        "per_rank_bn_control_fails": control_fails,
        "stats_gate": stats_gate, "gates": gates,
        "seconds": worlds["gloo_2_ranks"]["seconds"]}
    result["timing_not_gated"] = {
        "step_ms_one_process": ref["step_ms"],
        "step_ms_nccl_1_rank": one["step_ms"],
        "step_ms_gloo_2_ranks_one_card": [r["step_ms"] for r in two],
        "grad_allreduce_ms": {"gloo_2_ranks": [r["grad_allreduce_ms"]
                                               for r in two],
                              "nccl_1_rank": one["grad_allreduce_ms"]},
        "bn_collectives_ms_per_step": {
            "gloo_2_ranks": [r["bn_collectives_ms_per_step"] for r in two],
            "nccl_1_rank": one["bn_collectives_ms_per_step"]},
        "bn_layers": one["bn_layers"], "grad_bytes": one["grad_bytes"],
        "nccl_1_rank_backend": one["backend"]}
    for c in cmp:
        require(c["backend"] == "gloo", f"two ranks on one card: {c}")
        for k, bound in bounds.items():
            require(c[k] <= bound, f"2 ranks vs one process: {k} {c[k]} > "
                                   f"{bound} (4x the reordering spread)")
        # and train_parity's gates
        require(c["loss_rel"] <= gates["loss_rel_vs_f32"]
                and c["acc_max_abs"] <= gates["loss_rel_vs_f32"],
                f"2 ranks vs one process: loss/accuracy {c}")
        require(c["grad_err"] <= gates["grad_err_vs_f32"]
                and c["param_update_err"] <= gates["grad_err_vs_f32"],
                f"2 ranks vs one process: gradients/parameters {c}")
        require(c["bn_stats_rel_err"] <= stats_gate,
                f"2 ranks vs one process: BN stats {c} > {stats_gate}")
        require(c["launches"] == LAUNCHES_PER_TRAIN_STEP,
                f"rank launches {c['launches']}")
    require(same, "the two ranks' parameters differ")
    require({"bn_stats_rel_err", "loss_rel"} <= set(control_fails),
            f"per-rank BN moments passed the BN stats or loss bound: "
            f"{control} within {bounds}")
    require(one["backend"] == "nccl" and one["launches"]
            == LAUNCHES_PER_TRAIN_STEP, f"NCCL rank: {one['backend']}, "
                                        f"{one['launches']}")
    counts += [r["launches"] for r in two] + [one["launches"]]
    if keep is not None:  # for the model_axis phase
        keep.update(bounds=bounds, distance=distance, plain=plain,
                    cfg_path=cfg_path,
                    gloo_step_ms=[r["step_ms"] for r in two],
                    one_process_step_ms=ref["step_ms"])
    del plain_ref, reordered, worlds, two, one  # ref: on the host
    torch.cuda.empty_cache()

    result["seconds"] = time.time() - t_phase
    emit(result)
    print(card_line(), flush=True)
    return {k: sum(c.get(k, 0) for c in counts) for k in ops.KERNELS}


def _ma_rank(rank, out):
    """One rank of the model_axis phase's spawned worlds: a (world / 2, 2)
    mesh over gloo ranks sharing the card, train_parity's weights and its
    fixed b16 batch (this data index's share), the weights with 256 or
    more output channels sharded (tp_min_features' default), one Adam
    step of the kernel path with its launches, then 3 more timed with
    CUDA events; rank 0 writes the checkpoint of the gathered slices.
    Writes ``<out>/rank<r>.pt``: the whole gradients and state after
    the first step, the slices and moments this rank holds at the end,
    the bytes of its parameters and moments."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.mesh import make_mesh
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.parallel import distributed
    from ubresnet_tpu_torch.parallel.sharding import (
        make_param_shardings,
        param_state_bytes,
        shard_batch,
        shard_state,
        whole_optimizer_state,
        whole_state_dict,
    )
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )
    from ubresnet_tpu_torch.train.checkpoint import save_checkpoint
    from ubresnet_tpu_torch.utils.platform import resolve_device

    distributed.initialize(device="cuda")
    dev = resolve_device("cuda")
    mesh = make_mesh(model_axis=2)
    model = get_model("uresnet", random_state_dict(seed=0), device=dev,
                      train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    sharded = sorted(make_param_shardings(model, mesh))
    state = shard_state(create_train_state(model, opt), mesh)
    step = build_train_step(use_pallas_loss=True, device=dev, mesh=mesh)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in shard_batch(_train_batch(7), mesh).items()}
    ops.reset_launch_counts()
    state, m = step(state, b)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    grads = {}
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            shard = getattr(mod, "model_shard", None)
            if shard is not None:
                grads[f"{mod_name}.weight"] = shard.gather(mod.weight.grad)
    res = {"backend": distributed.backend(), "device": str(dev),
           "mesh": [mesh.data_size, mesh.model_size, mesh.data_rank,
                    mesh.model_rank], "metrics": m, "launches": launches,
           "sharded": sharded, "bytes": param_state_bytes(state),
           "grads": {k: grads.get(k, p.grad).float().cpu()
                     for k, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in whole_state_dict(model).items()}}
    state, _, res["step_ms"] = _adam_steps(step, state, b, n=3)
    whole = (whole_state_dict(model), whole_optimizer_state(state))
    if rank == 0:
        res["tar"] = save_checkpoint(os.path.join(out, "ck"), state,
                                     whole=whole)
    names = {id(p): k for k, p in model.named_parameters()}
    res["slices"] = {k: v.cpu() for k, v in model.state_dict().items()}
    res["moments"] = {names[id(p)]: {k: v.cpu() for k, v in st.items()
                                     if torch.is_tensor(v) and v.dim()}
                      for p, st in opt.opt.state.items()}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier("rank_done")
    distributed.shutdown()


def model_axis_path(dev, card, work, gates, dist):
    """The model axis (channel sharding) at the flagship width, two gloo
    ranks and four sharing the card, beside the distributed phase, whose
    one-process step, reordering bounds and plain train CLI run it takes
    (``dist``). Spawned worlds (1, 2) and (2, 2): one Adam step on
    train_parity's b16 batch against one process under the distributed
    phase's gates (4x the reordering spread, train_parity's), the
    per-rank launches of one step exact, each rank's bytes of parameters
    plus Adam moments the replicated bytes plus half the sharded ones,
    rank 0's checkpoint (after 4 steps) restored by a one-process
    trainer state with every tensor equal to the ranks' slices put
    together. Then ``cli.launch --distributed 2 --set model_axis=2`` for
    DIST_ITERS iterations of the distributed phase's config: its first
    loss (the weights not yet updated) within 4x the reordering spread
    of the plain CLI's, the losses finite and falling, its launches
    DIST_ITERS x the step table, each rank's mesh and bytes. The later
    losses are reported against the plain CLI's, not gated: from the
    first update on, Adam's sign steps (±lr where a gradient is near 0)
    carry the channel split's last bits into the weights, as they carry
    a different sum order's; the spawned worlds hold the step itself.
    Reported: the step ms beside the two-data-rank gloo step of the same
    run. Every result is emitted before a failed gate raises."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.mesh import Mesh
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.parallel.sharding import make_param_shardings
    from ubresnet_tpu_torch.train import create_train_state, make_optimizer
    from ubresnet_tpu_torch.train.checkpoint import restore_checkpoint
    from torch_dist_workers import run_spawned

    t_phase = time.time()
    root = os.path.join(work, "model_axis")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bounds, distance = dist["bounds"], dist["distance"]
    result = {"phase": "model_axis", "card": card, "bounds": bounds}
    counts, failed = [], []
    # the bytes a rank should hold: f32 parameters and two Adam moments,
    # the sharded weights halved
    full = get_model("uresnet", random_state_dict(seed=0), device=dev,
                     train=True)
    params = dict(full.named_parameters())
    sharded = make_param_shardings(full, Mesh(2, 0, None, 2))
    want_bytes = 3 * 4 * sum(p.numel() // (2 if k in sharded else 1)
                             for k, p in params.items())
    result["sharded"] = sorted(sharded)
    result["bytes_replicated"] = 3 * 4 * sum(p.numel()
                                             for p in params.values())
    result["bytes_per_rank_want"] = want_bytes
    for name, n in (("model_2", 2), ("data_2_model_2", 4)):
        out_dir = os.path.join(root, name)
        os.makedirs(out_dir)
        t0 = time.time()
        run_spawned(_ma_rank, n, (out_dir,), timeout_s=300)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
        cmp = [dict(distance(r), backend=r["backend"], mesh=r["mesh"],
                    launches=r["launches"], bytes=r["bytes"])
               for r in ranks]
        # rank 0's file, restored by a one-process trainer state
        opt = make_optimizer(full.parameters(), "adam", 1e-3,
                             weight_decay=1e-4)
        state = restore_checkpoint(os.path.join(out_dir, "ck"),
                                   create_train_state(full, opt))
        sd = {k: v.cpu() for k, v in state.model.state_dict().items()}
        moments = {k: opt.opt.state[p] for k, p in params.items()}
        tar_equal = True
        for k, v in sd.items():
            parts = [ranks[m]["slices"][k] for m in range(2)]
            dim = 1 if k.endswith("deconv.weight") else 0
            whole = torch.cat(parts, dim) if k in sharded else parts[0]
            tar_equal &= torch.equal(whole, v)
        for k, st in moments.items():
            for mk in ("exp_avg", "exp_avg_sq"):
                parts = [ranks[m]["moments"][k][mk] for m in range(2)]
                dim = 1 if k.endswith("deconv.weight") else 0
                whole = torch.cat(parts, dim) if k in sharded else parts[0]
                tar_equal &= torch.equal(whole, st[mk].cpu())
        result[name] = {"vs_one_process": cmp, "tar_equal_slices": tar_equal,
                        "step_ms": [r["step_ms"] for r in ranks],
                        "seconds": time.time() - t0}
        for c in cmp:
            if c["backend"] != "gloo":
                failed.append(f"{name}: backend {c['backend']}")
            failed += [f"{name} vs one process: {k} {c[k]} > {bound}"
                       for k, bound in bounds.items() if c[k] > bound]
            if not (c["loss_rel"] <= gates["loss_rel_vs_f32"]
                    and c["grad_err"] <= gates["grad_err_vs_f32"]):
                failed.append(f"{name} vs one process: train_parity's "
                              f"gates {c}")
            if c["launches"] != LAUNCHES_PER_TRAIN_STEP:
                failed.append(f"{name}: rank launches {c['launches']}")
            if c["bytes"] != want_bytes:
                failed.append(f"{name}: {c['bytes']} bytes, want "
                              f"{want_bytes}")
        if not all(r["sharded"] == sorted(sharded) for r in ranks):
            failed.append(f"{name}: sharded sets differ")
        if not tar_equal:
            failed.append(f"{name}: the checkpoint is not the ranks' "
                          "slices put together")
        counts += [r["launches"] for r in ranks]
        del ranks, state
    del full, params
    torch.cuda.empty_cache()

    # the entry point: launch --distributed 2 --set model_axis=2
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "ubresnet_tpu_torch.cli.launch",
         "--distributed", "2", "--config", dist["cfg_path"], "--workdir",
         os.path.join(root, "cli"), "--set", "model_axis=2", "--set",
         f"checkpoint_dir={root}/cli_ck", "--set", f"log_dir={root}/cli_log"],
        capture_output=True, text=True, env=env, cwd=HERE, timeout=600)
    wall = time.time() - t0
    logs = [open(os.path.join(root, "cli", f"proc{r}.log")).read()
            for r in range(2)]
    if proc.returncode:
        emit(result)
    require(proc.returncode == 0, f"launch --distributed 2 --set "
            f"model_axis=2 returned {proc.returncode}:\n"
            f"{proc.stdout[-2000:]}\n{logs[0][-3000:]}\n{logs[1][-2000:]}")
    losses = _jsonl_losses(os.path.join(root, "cli_log", "run.jsonl"))
    plain = dist["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    summaries = [_summary(log) for log in logs]
    want = {k: v * DIST_ITERS for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
    cli_counts = [{k: v for k, v in s["kernel_launches"].items() if v}
                  for s in summaries]
    result["cli"] = {
        "wall_s": wall, "losses": losses, "plain_losses": plain,
        "loss_rel_vs_plain": rel, "launches": cli_counts,
        "mesh": [s["mesh"] for s in summaries],
        "bytes": [s["param_state_bytes"] for s in summaries],
        "step_s": [s["meters"].get("time/step") for s in summaries]}
    if not (len(losses) == DIST_ITERS and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        failed.append(f"CLI losses {losses}")
    elif rel[0] > bounds["loss_rel"]:
        failed.append(f"CLI first loss {losses[0]} vs plain {plain[0]}: "
                      f"{rel[0]} > {bounds['loss_rel']}")
    if not all(c == want for c in cli_counts):
        failed.append(f"CLI launches {cli_counts} != {want}")
    if not all(s["mesh"] == [1, 2] and s["param_state_bytes"] == want_bytes
               for s in summaries):
        failed.append(f"CLI mesh and bytes {result['cli']}")
    counts += cli_counts
    result["step_ms_vs_two_data_ranks"] = {
        "model_2": result["model_2"]["step_ms"],
        "data_2_model_2": result["data_2_model_2"]["step_ms"],
        "gloo_2_data_ranks": dist["gloo_step_ms"],
        "one_process": dist["one_process_step_ms"]}
    result["seconds"] = time.time() - t_phase
    emit(result)
    print(card_line(), flush=True)
    require(not failed, f"model_axis: {failed}")
    return {k: sum(c.get(k, 0) for c in counts) for k in ops.KERNELS}


GOLDEN_EVENTS = 2            # events of the golden phase's 3-plane file
# The dry run's: its negative control (plane 2's weights x 1 + 0.2·randn)
# cleared the bar of 1 pixel in 1000 by about one pixel over 2 events
# (1.4 in 1000), by about 35 over 16 (3.5 in 1000; H100).
GOLDEN_DRY_EVENTS = 16
# max|Δp| of the f32 oracle's softmax against float64 on one 512² crop:
# 7.6e-6-8.3e-6 with TF32 off, 6.8e-3 with it on (H100).
F32_DP_LIMIT = 1e-4


@contextlib.contextmanager
def _tf32_on():
    """Stands in for parity/caffe.py's strict_f32_scope in the oracle's
    negative control: TF32 on for the body."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _golden_scores(path, n, hw):
    """Every event of ``path`` carries, for each plane 0-2, 3 float32
    ``ssnet_plane%d`` images of ``hw`` summing to 1 ± 1e-5; returns the
    largest deviation of a sum."""
    import numpy as np

    from ubresnet_tpu_torch.data.rootio import open_event_file

    reader = open_event_file(path)
    require(len(reader) == n, f"{path}: {len(reader)} events written")
    worst = 0.0
    for i in range(n):
        ev = reader.read_entry(i)
        for plane in (0, 1, 2):
            imgs = ev.get(f"ssnet_plane{plane}", [])
            require(len(imgs) == 3 and all(
                im.pixels.dtype == np.float32 and im.pixels.shape == hw
                for im in imgs), f"event {i} plane {plane}: bad scores")
            s = np.stack([im.pixels for im in imgs])
            require(np.isfinite(s).all(), f"event {i}: non-finite scores")
            worst = max(worst, float(np.abs(s.sum(0) - 1.0).max()))
    require(worst <= 1e-5, f"{path}: score sums off by {worst}")
    return worst


def _leg_timings(text):
    """The infer_caffe timing lines in ``text``, one a caffe leg."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{"total"')]


def golden_path(dev, card, work):
    """The 2018-paper Caffe parity stack at the oracle shape (512²,
    inplanes 16): surrogate caffemodels (sha256, draw+write, parse and
    write seconds of one, the rewrite byte-equal), infer_caffe --device
    cuda over a 3-plane file (score sums, forward ms, f32 against
    float64 on one crop), golden_parity --dry-run, and official mode on
    a tame reference .tar, whose second leg (the port's infer_precropped,
    one batch a plane) is the golden path's kernel launches."""
    import hashlib
    import pathlib
    import tempfile

    import numpy as np
    import torch

    from ubresnet_tpu_torch.cli import golden_parity
    from ubresnet_tpu_torch.cli.infer_caffe import main as infer_caffe
    from ubresnet_tpu_torch.data.rootio import open_event_file
    from ubresnet_tpu_torch.deploy.weights import (
        random_state_dict,
        save_reference_checkpoint,
    )
    from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
    from ubresnet_tpu_torch.parity import caffe
    from ubresnet_tpu_torch.parity.caffe import (
        CaffeNet,
        parse_caffemodel,
        write_caffemodel,
    )

    t_phase = time.time()
    root = os.path.join(work, "golden")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    result = {"phase": "golden", "card": card, "hw": list(HW),
              "events": GOLDEN_EVENTS}

    t0 = time.time()
    weights = golden_parity.make_surrogate_weights(root)
    result["surrogates_draw_write_s"] = time.time() - t0
    result["surrogate_sha256"] = {
        str(p): hashlib.sha256(pathlib.Path(f).read_bytes()).hexdigest()
        for p, f in weights.items()}
    result["caffemodel_bytes"] = os.path.getsize(weights[2])
    t0 = time.time()
    params = parse_caffemodel(weights[2])
    result["caffemodel_parse_s"] = time.time() - t0
    again = os.path.join(root, "rewrite.caffemodel")
    t0 = time.time()
    write_caffemodel(again, params)
    result["caffemodel_write_s"] = time.time() - t0
    require(pathlib.Path(again).read_bytes() ==
            pathlib.Path(weights[2]).read_bytes(),
            "parse → write of a surrogate changed its bytes")

    events = golden_parity.make_three_plane_file(
        os.path.join(root, "events.uevt"), GOLDEN_EVENTS, HW)
    scores = os.path.join(root, "caffe.uevt")
    argv = ["-i", events, "-o", scores, "--device", "cuda"]
    for plane, path in weights.items():
        argv += ["-w", f"{plane}:{path}"]
    rc, out, _, wall, launches = _run_cli(infer_caffe, argv)
    require(rc == 0, f"infer_caffe returned {rc}")
    require(not any(launches.values()),
            f"the caffe oracle launched port kernels: {launches}")
    result["infer_caffe"] = {"wall_s": wall, "timing": _leg_timings(out)[-1],
                             "score_sum_max_dev": _golden_scores(
                                 scores, GOLDEN_EVENTS, HW)}

    # one crop: the card's f32 oracle against the same net in float64,
    # and a control with TF32 let in, which the max|Δp| gate must catch
    crop = open_event_file(events).read_entry(0)["wire"][2].pixels
    x = torch.from_numpy(np.ascontiguousarray(crop[None, ..., None])).to(dev)
    net = CaffeNet(ssnet2018_prototxt(), weights=params, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: net(x)["softmax"], budget_ms=300.0)
        profile = forward_profile(lambda: net(x)["softmax"], fwd_ms)
        p32 = net(x)["softmax"][0]
        strict = caffe.strict_f32_scope
        caffe.strict_f32_scope = _tf32_on
        try:
            ptf = net(x)["softmax"][0]
        finally:
            caffe.strict_f32_scope = strict
        p64 = net.double()(x)["softmax"][0]
    mask = torch.from_numpy(crop > 10.0).to(dev)
    agree = float((p32.argmax(-1) == p64.argmax(-1))[mask].double().mean())
    dp = float((p32.double() - p64).abs().max())
    dp_tf32 = float((ptf.double() - p64).abs().max())
    result.update({"forward_ms_b1": fwd_ms, "profile_b1": profile,
                   "f32_vs_f64": {"label_agreement_adc10": agree,
                                  "max_abs_dp": dp,
                                  "max_abs_dp_limit": F32_DP_LIMIT,
                                  "max_abs_dp_tf32_control": dp_tf32,
                                  "n_pixels": int(mask.sum())}})
    require(agree >= 0.999, f"f32 oracle vs float64: agreement {agree}")
    require(dp <= F32_DP_LIMIT, f"f32 oracle vs float64: max|Δp| {dp}")
    require(dp_tf32 > F32_DP_LIMIT,
            f"the TF32 control passed the max|Δp| gate: {dp_tf32}")
    del net, p32, ptf, p64
    torch.cuda.empty_cache()

    saved, tempfile.tempdir = tempfile.tempdir, root
    try:
        report = os.path.join(root, "dry_run.json")
        rc, out, _, wall, _ = _run_cli(golden_parity.main, [
            "--dry-run", "--device", "cuda", "-n", str(GOLDEN_DRY_EVENTS),
            "-o", report])
        rep = json.loads(pathlib.Path(report).read_text())
        require(rc == 0 and rep["ok"], f"dry run returned {rc}: {rep}")
        require(all(m["label_agreement"] >= 0.999
                    for m in rep["planes"].values())
                and rep["negative_control"]["detected"],
                f"dry run gates: {rep}")
        neg = rep["negative_control"]
        result["dry_run"] = {
            "wall_s": wall, "legs": _leg_timings(out),
            "planes": rep["planes"], "negative_control": neg,
            # disagreeing pixels past the most the bar lets through
            "negative_margin_px": neg["n_entries"] * neg["n_pixels"] * (
                rep["threshold"] - neg["label_agreement"])}

        sd = random_state_dict(seed=2)
        sd["conv11.weight"] = sd["conv11.weight"] * 3e-5  # unsaturated
        tar = save_reference_checkpoint(sd, os.path.join(root, "tame.tar"))
        report = os.path.join(root, "official.json")
        argv = ["-i", events, "-c", tar, "--device", "cuda", "-n",
                str(GOLDEN_EVENTS), "-o", report]
        for plane, path in weights.items():
            argv += ["-w", f"{plane}:{path}"]
        rc, out, _, wall, launches = _run_cli(golden_parity.main, argv)
    finally:
        tempfile.tempdir = saved
    rep = json.loads(pathlib.Path(report).read_text())
    require(rc == (0 if rep["ok"] else 1), f"official mode returned {rc}")
    require(sorted(rep["planes"]) == ["0", "1", "2"] and all(
        m["n_pixels"] > 0 for m in rep["planes"].values()),
        f"official mode planes: {rep['planes']}")
    want = {k: LAUNCHES_PER_BATCH.get(k, 0) * 3 for k in launches}
    require(launches == want, f"official mode launches {launches} != {want}")
    result["official"] = {"wall_s": wall, "ok": rep["ok"],
                          "planes": rep["planes"], "launches": launches}
    result["seconds"] = time.time() - t_phase
    emit(result)
    return launches


def _deploy_cli(src, out, tar, extra=()):
    """infer_precropped -b 16 --device cuda (``extra`` added): (wall s,
    launches, the timing line)."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as cli

    printed = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = cli(["-i", src, "-o", out, "-c", tar, "-b", str(BATCH_MAIN),
                  "--device", "cuda", *extra])
    torch.cuda.synchronize()
    wall = time.time() - t0
    require(rc == 0, f"CLI {' '.join(extra)} returned {rc}")
    lines = printed.getvalue().strip().splitlines()
    return wall, ops.launch_counts(), json.loads(lines[-1])


def _widths_deploy(dev, card, work, sd, name, classes, table, table_int8,
                   flagship_ms, arch="uresnet"):
    """The main phase's 64 crops through infer_precropped on ``sd`` (a
    reference .tar of an ``arch`` model), bf16 and --int8: score images,
    exact launches a batch, the b16 forward against f32 and the int8
    kernel path against the int8 plain path (argmax ≥ 0.99 each).
    Returns both paths' launches."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import save_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model

    src = os.path.join(work, "crops.uevt")
    tar = save_reference_checkpoint(sd, os.path.join(work, f"{name}.tar"))
    out, out8 = (os.path.join(work, f"{name}{t}.uevt") for t in ("", "_int8"))
    batches = -(-EVENTS // BATCH_MAIN)
    wall, launches, timing = _deploy_cli(src, out, tar)
    want = {k: table.get(k, 0) * batches for k in launches}
    require(launches == want, f"{name} launch counts {launches} != {want}")
    worst = _check_scores(out, EVENTS, "uburn_plane2", HW, classes=classes)
    wall8, launches8, timing8 = _deploy_cli(
        src, out8, tar, ("--int8", "--int8-calib", str(INT8_CALIB)))
    want8 = {k: table_int8.get(k, 0) * batches for k in launches8}
    require(launches8 == want8,
            f"{name} int8 launch counts {launches8} != {want8}")
    worst8 = _check_scores(out8, EVENTS, "uburn_plane2", HW, classes=classes)

    inp = EventFileReader(src)
    x = torch.from_numpy(np.stack(
        [inp.read_entry(i, producers=["wire"])["wire"][0].pixels
         for i in range(BATCH_MAIN)])[..., None]).to(dev)
    model = get_model(arch, sd, device=dev)
    int8 = get_model(arch, sd, policy=Policy.int8(), device=dev)
    PrecroppedRunner(int8, batch_size=BATCH_MAIN).calibrate_from(
        src, n_images=INT8_CALIB)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        int8_ms = time_ms(lambda: int8(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        agree = float((model(x).argmax(-1) == get_model(
            arch, sd, policy=Policy.f32(), device=dev)(x).argmax(-1))
            .float().mean())
        lp8 = int8(x)
        with plain_kernels():
            lp8_plain = int8(x)
    agree8 = float((lp8.argmax(-1) == lp8_plain.argmax(-1)).float().mean())
    emit({"phase": "widths", "path": name, "card": card, "arch": arch,
          "classes": classes, "events": EVENTS, "batch": BATCH_MAIN,
          "hw": list(HW), "cli_wall_s": wall,
          "crops_per_s_file_to_file": EVENTS / wall, "timing": timing,
          "launches": launches, "classifier": list(model.conv11.shape),
          "score_sum_max_dev": worst, "forward_ms_b16": fwd_ms,
          "crops_per_s_forward_b16": BATCH_MAIN / fwd_ms * 1e3,
          "stage_ms_b16": stages, "flagship_forward_ms_b16": flagship_ms,
          "argmax_agreement_b16_vs_f32": agree,
          "int8": {"cli_wall_s": wall8, "timing": timing8,
                   "launches": launches8, "score_sum_max_dev": worst8,
                   "forward_ms_b16": int8_ms,
                   "argmax_agreement_kernel_vs_plain": agree8},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    require(agree >= 0.99, f"{name}: kernel path vs f32 argmax {agree}")
    require(agree8 >= 0.99, f"{name}: int8 kernel vs plain argmax {agree8}")
    # the K1 launches of the run include the classifier's at its shape
    require(model.conv11.kernel and model.conv11.shape == (16, classes, 7),
            f"{name}: the classifier {model.conv11.shape} is off K1")
    return launches, launches8


def _widths_train_cli(dev, card, work):
    """The train CLI with --set model.inplanes=32 on 64 synthetic 256²
    events: 4 iterations, one validation; finite losses, exact
    launches."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    data = os.path.join(work, "train_256.uevt")
    ckpt = os.path.join(work, "train_32_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    make_synthetic_file(data, n_events=EVENTS, hw=TRAIN_HW_32, seed=2)
    cfg = {"model": {"precision": "bf16", "inplanes": 32},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": WIDTHS_ITERS, "print_every": 1,
           "valid_every": WIDTHS_ITERS, "valid_batches": 1,
           "checkpoint_every": WIDTHS_ITERS, "checkpoint_dir": ckpt,
           "seed": 0}
    cfg_path = os.path.join(work, "train_32.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    printed = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = train_cli(["--config", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    out = printed.getvalue()
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    want = {k: (LAUNCHES_PER_TRAIN_STEP_32.get(k, 0) * WIDTHS_ITERS
                + LAUNCHES_PER_BATCH_32.get(k, 0)) for k in launches}
    emit({"phase": "widths", "path": "train_cli_inplanes32", "card": card,
          "events": EVENTS, "batch": BATCH_MAIN, "hw": list(TRAIN_HW_32),
          "iters": WIDTHS_ITERS, "rc": rc, "cli_wall_s": wall,
          "losses": losses, "final_iter": summary.get("final_iter"),
          "launches": launches, "launches_want": want,
          "meters": summary.get("meters")})
    require(rc == 0 and "error" not in summary, f"train CLI failed:\n{out}")
    require(summary["final_iter"] == WIDTHS_ITERS,
            f"final_iter {summary['final_iter']}")
    require(len(losses) == WIDTHS_ITERS and np.isfinite(losses).all(),
            f"losses {losses}")
    require(launches == want, f"inplanes-32 train CLI launch counts "
                              f"{launches} != {want}")
    return launches


def widths_path(dev, card, work, flagship_ms):
    """The reference's other two UResNets on the card's kernels: the
    trainer's (inplanes 32) and the deploy's (4 classes), each deployed
    bf16 and int8 and trained, every layer routed as the JAX package
    routes it. Returns the launches of each path."""
    import torch

    from ubresnet_tpu_torch.deploy.weights import random_state_dict

    t_phase = time.time()
    launches = {}
    sd32 = random_state_dict(seed=0, inplanes=32)
    launches["widths_32"], launches["widths_32_int8"] = _widths_deploy(
        dev, card, work, sd32, "inplanes32", 3, LAUNCHES_PER_BATCH_32,
        LAUNCHES_PER_BATCH_INT8_32, flagship_ms)
    torch.cuda.empty_cache()
    ref = train_parity(dev, card, phase="widths_train_inplanes32", sd=sd32,
                       batch=_train_batch(7, TRAIN_HW_32),
                       want_step=LAUNCHES_PER_TRAIN_STEP_32)
    torch.cuda.empty_cache()
    launches["widths_32_train"] = _merge(
        ref["launches"], _widths_train_cli(dev, card, work))
    torch.cuda.empty_cache()
    sd4 = random_state_dict(seed=0, num_classes=4)
    launches["widths_4"], launches["widths_4_int8"] = _widths_deploy(
        dev, card, work, sd4, "classes4", 4, LAUNCHES_PER_BATCH,
        LAUNCHES_PER_BATCH_INT8, flagship_ms)
    torch.cuda.empty_cache()
    ref = train_parity(dev, card, phase="widths_train_classes4", sd=sd4,
                       batch=_train_batch(7, classes=4))
    launches["widths_4_train"] = ref["launches"]
    emit({"phase": "widths", "seconds": time.time() - t_phase})
    return launches


def widths8_path(dev, card, work, flagship_ms, rows):
    """The UResNets at 8-channel streams (inplanes 8 and 4, seeded
    random weights) on the card's kernels, every layer routed as the JAX
    package routes it: the 64 crops through infer_precropped in bf16 and
    --int8, launches exact a batch; train_parity's gates and 5 Adam
    steps on its b16 batch in the default zone and with
    fused_train_deconv, launches exact a step. Then ASPP-ResNet at
    inplanes 32 through infer_precropped, bf16 and --int8. Returns the
    launches of each path."""
    import torch

    from ubresnet_tpu_torch.deploy.weights import random_state_dict

    t_phase = time.time()
    launches = {}
    for ip in (8, 4):
        sd = random_state_dict(seed=0, inplanes=ip)
        launches[f"widths_ip{ip}"], launches[f"widths_ip{ip}_int8"] = (
            _widths_deploy(dev, card, work, sd, f"inplanes{ip}", 3,
                           LAUNCHES_PER_BATCH_8[ip],
                           LAUNCHES_PER_BATCH_INT8_8[ip], flagship_ms))
        torch.cuda.empty_cache()
        ref = train_parity(dev, card, phase=f"widths_train_inplanes{ip}",
                           sd=sd, batch=_train_batch(7),
                           want_step=LAUNCHES_PER_TRAIN_STEP_8[ip])
        launches[f"widths_ip{ip}_train"] = ref["launches"]
        torch.cuda.empty_cache()
        launches[f"widths_ip{ip}_train_deconv"] = train_deconv(
            dev, card, ref, rows, phase=f"widths_train_deconv_inplanes{ip}",
            sd=sd, want_step=LAUNCHES_PER_DECONV_STEP_8[ip],
            cell=f"{MAIN_CELL} inplanes {ip}")
        del ref
        torch.cuda.empty_cache()
    sd = random_state_dict(seed=0, inplanes=32, arch="aspp_resnet")
    launches["aspp_32"], launches["aspp_32_int8"] = _widths_deploy(
        dev, card, work, sd, "aspp_inplanes32", 3, LAUNCHES_PER_BATCH_ASPP_32,
        LAUNCHES_PER_BATCH_INT8_ASPP_32, flagship_ms, arch="aspp_resnet")
    torch.cuda.empty_cache()
    emit({"phase": "widths_8", "seconds": time.time() - t_phase})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on the card", file=sys.stderr)
        return 1
    from ubresnet_tpu_torch.ops import _build
    from ubresnet_tpu_torch.utils.platform import strict_f32

    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(host_libraries)  # g++ beside the nvcc builds
        lib = _build.build()
        host_build = host.result()
    report = _build.ptxas_report()
    PTXAS.update({r["kernel"]: {k: r.get(k) for k in (
        "registers", "spill_stores", "spill_loads", "stack_bytes")}
        for r in report})
    emit({"phase": "build", "seconds": time.time() - t0, "library": str(lib),
          "host": host_build, "ptxas": report})

    strict_f32()  # the plain versions are f32 cuDNN convs: no TF32
    dev = torch.device("cuda", 0)
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    seconds, mark = {}, [time.time()]

    def lap(phase):  # the seconds each phase took
        seconds[phase] = time.time() - mark[0]
        mark[0] = time.time()

    rows = check_kernels(kernel_rows(dev))
    rows += check_kernels(int8_kernel_rows(dev, rows))
    for B, hw in WV_SHAPES:  # the zone at the wholeview paths' shapes
        wv = check_kernels(kernel_rows(dev, B, hw))
        rows += wv + check_kernels(int8_kernel_rows(dev, wv, B, hw))
        torch.cuda.empty_cache()
    rows += check_kernels(train_kernel_rows(dev))
    rows += check_kernels(deconv_ad_rows(dev))
    # the reference's other two UResNets (widths phase): the inplanes-32
    # zone at the main cell, bf16 and int8, its streamed K2 / K2-s8
    # blocks also at the wholeview cells, its train zone on 256² crops;
    # the 4-class classifier and its train legs
    w32 = check_kernels(kernel_rows(dev, inplanes=32))
    rows += w32 + check_kernels(int8_kernel_rows(dev, w32, inplanes=32))
    rows += check_kernels(kernel_rows(dev, classes=4,
                                      only={"classifier conv11"}))
    for B, hw in WV_SHAPES:
        wv = check_kernels(kernel_rows(dev, B, hw, inplanes=32,
                                       only=STREAMED))
        rows += wv + check_kernels(int8_kernel_rows(
            dev, wv, B, hw, inplanes=32, only=STREAMED_S8))
        torch.cuda.empty_cache()
    rows += check_kernels(train_kernel_rows(
        dev, TRAIN_ZONE_32, CLASSIFIER_32, model="inplanes 32",
        cell_hw=TRAIN_HW_32, loss_rows=False))
    rows += check_kernels(train_kernel_rows(
        dev, [], CLASSIFIER_4, classes=4, model="4 classes"))
    # the inplanes-32 trainer's deconv-AD upsample (dec1 (64, 32) on its
    # 256² crops) and its classifier's train forward at 256²
    rows += check_kernels(deconv_ad_rows(
        dev, (("dec1", 128, 64, 32),), model="inplanes 32",
        cell_hw=TRAIN_HW_32))
    rows += check_kernels(kernel_rows(dev, hw=TRAIN_HW_32, inplanes=32,
                                      only={"classifier conv11"}))
    # the 8-channel streams (widths_8 phase): the eval and int8 zones,
    # the train zones and the deconv-AD upsamples at inplanes 8 and 4
    for ip in (8, 4):
        w8 = check_kernels(kernel_rows(dev, inplanes=ip))
        rows += w8 + check_kernels(int8_kernel_rows(dev, w8, inplanes=ip))
        rows += check_kernels(train_kernel_rows(
            dev, TRAIN_ZONE_8[ip], CLASSIFIER, model=f"inplanes {ip}",
            loss_rows=False))
        rows += check_kernels(deconv_ad_rows(dev, DECONV_AD_8[ip],
                                             model=f"inplanes {ip}"))
        torch.cuda.empty_cache()
    lap("kernels")
    emit(train_zone_per_step(rows))
    emit(train_zone_per_step(rows, "per_step_ad", LAUNCHES_PER_DECONV_STEP,
                             "train_deconv_per_step"))
    torch.cuda.empty_cache()
    launches = {}
    launches["precropped"], flagship_ms = main_path(dev, card, work)
    lap("main")
    ref = train_parity(dev, card)
    lap("train_parity")
    torch.cuda.empty_cache()
    launches["train_deconv"] = train_deconv(dev, card, ref, rows)
    lap("train_deconv")
    gates = ref["gates"]
    del ref
    torch.cuda.empty_cache()
    launches["train"] = train_path(dev, card, work)
    lap("train")
    torch.cuda.empty_cache()
    launches["qat"] = qat_path(dev, card, work)
    lap("qat")
    torch.cuda.empty_cache()
    launches["int8"] = int8_path(dev, card, work)
    lap("int8")
    torch.cuda.empty_cache()
    launches["wholeview"] = wholeview_path(dev, card, work)
    lap("wholeview")
    launches["spatial_devices"] = spatial_devices_path(dev, card, work)
    lap("spatial_devices")
    torch.cuda.empty_cache()
    launches["serve"] = serve_path(dev, card, work)
    lap("serve")
    torch.cuda.empty_cache()
    launches["root"] = root_path(dev, card, work, gates, host_build)
    lap("root")
    torch.cuda.empty_cache()
    launches.update(aspp_path(dev, card, work))
    lap("aspp")
    torch.cuda.empty_cache()
    dist = {}
    launches["distributed"] = distributed_path(dev, card, work, gates, dist)
    lap("distributed")
    launches["model_axis"] = model_axis_path(dev, card, work, gates, dist)
    del dist
    lap("model_axis")
    torch.cuda.empty_cache()
    launches["golden"] = golden_path(dev, card, work)
    lap("golden")
    torch.cuda.empty_cache()
    launches.update(widths_path(dev, card, work, flagship_ms))
    lap("widths")
    torch.cuda.empty_cache()
    launches.update(widths8_path(dev, card, work, flagship_ms, rows))
    lap("widths_8")
    emit({"phase": "phase_seconds", "seconds": seconds})
    line = kernels_line(rows, launches)
    for k in line["kernels"]:
        paths = SOURCES[k["name"]][3]
        require(all(k["launches_by_path"][p] > 0 for p in paths),
                f"{k['name']} was not launched on its main path "
                f"{paths}: {k['launches_by_path']}")
    emit(line)
    emit({"phase": "elapsed", "seconds": time.time() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
