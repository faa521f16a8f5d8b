#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pointvit_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

1. Builds the CUDA kernels from ``pointvit_tpu_torch/csrc`` (nvcc, sm_90a).
2. Serving: builds the APF ``slim2`` model at full width (E=768, 12 blocks
   x 12 heads, npoint 196, nsample 16, encoder second width 384, bf16) with
   random weights from a seeded ``torch.Generator``, and serves requests of
   1, 5, 32 and 256 clouds of 1024 points through ``InferenceSession`` on
   the kernel path. The same requests go through a session on the plain
   path (``implementation='torch'``) on the same card, and the logits must
   agree. Each serving kernel's launch count during the kernel-path
   requests must be above zero. Serving throughput at bucket 256 is timed
   for both paths.
3. Training: two ``Trainer``s on identical seeded ``slim2`` weights with 15
   classes, one on the kernel path and one on the plain path, take the same
   7 steps of 256 x 1024 clouds (masked AdamW, lr 5e-4, wd 5e-2, timm cosine
   schedule with warm-up, label smoothing 0.3, dropout and drop-path 0.1,
   random FPS starts, all drawn from one seeded CUDA generator per trainer
   in the same order). Every loss must be finite; the first loss and each
   trainable gradient of the first step, and the trainable parameters after
   the last, must agree between the paths; frozen parameters must not
   change; FPS, kNN and both attention kernels must launch during the 5
   timed steps. Both paths' ms per step and clouds/s are printed. Then one
   step of slim2 with npoint 1536 on 8 clouds of 4096 points, above the
   JAX package's Pallas gate for the attention backward, on both paths
   from the same weights, batch and draws: first loss and gradients held as
   above, and the attention backward kernel must launch. Then Pix4Point
   training: ``build_model`` of the ``train_pix4point.py`` config (vit_small,
   12 blocks x 6 heads, k 16, 15 classes, bf16) at full width and depth with
   seeded random weights, on both paths, 7 steps of 64 x 2048 clouds with
   the optimizer ``Pix4PointTrainer`` builds (``pix4point_optimizer``: warm-up
   then cosine from lr 5e-4, wd 5e-2 off for the no-decay names, clip 10),
   random FPS starts and the head's dropout drawn as above, an f32 first
   step as the gradient reference, held by the same gates; FPS, kNN and
   both attention kernels must launch during the timed steps and the fused
   P3 stage and ViT block kernels must not (training runs them unfused, as
   JAX does). One kernel-path step is split by CUDA events into tokenizer +
   P3, blocks, head + loss, backward and optimizer, and one step with the
   trunk frozen must leave every ``model.blocks.*`` and ``model.norm.*``
   tensor bit-unchanged and move ``cls_token`` and the head. Then renderer
   training: ``build_model`` of the ``train_renderer.py`` config (vit_b_16,
   12 blocks x 12 heads, 6 learned views of 224 x 224, bf16) at full width
   and depth with seeded random weights, on both paths, 7 steps of 16 x 2048
   unit-sphere clouds (96 images) with the optimizer ``RendererTrainer``
   builds (``renderer_optimizer``: constant lr 5e-4, wd 5e-2, no clip, only
   the ViT's adapters trained inside it) and the head's dropout drawn as
   above, an f32 first step as the gradient reference, held by the same
   gates; the frozen ViT tensors must stay bit-unchanged, every view-network
   gradient but the three before its BatchNorms must be nonzero on the
   kernel path, the attention forward and backward kernels must launch
   once a block and step each, and the serial-block, GEMM and LayerNorm
   kernels must not (the blocks run unfused and the patchify as a plain
   product in training, as JAX does). One kernel-path step is split by CUDA
   events into view network, render, patchify + pos, blocks, head + loss,
   backward and optimizer, and one runs under ``torch.profiler``.
4. Pix4Point serving: ``build_model`` of the ``train_pix4point.py`` config
   (vit_small: E=384, 12 blocks x 6 heads, k 16, 15 classes; bf16) at full
   width and depth with seeded random weights (BN statistics, LN affines,
   cls token and pos randomised too) serves requests of 1, 5, 32 and 256
   clouds of 2048 points through ``InferenceSession`` on the kernel path
   and on the plain path; the logits must agree as for APF, and the FPS,
   kNN, P3-stage, ViT-block, GEMM, LayerNorm, pos-LayerNorm and attention
   kernels must each launch. Both paths are timed at bucket 256, and the
   kernel path's forward is split by CUDA events into tokenizer, P3 stage,
   12 blocks and head.
5. Renderer serving: ``build_model`` of the ``train_renderer.py`` config
   (vit_b_16: patch 16, E=768, 12 blocks x 12 heads, adapter bottleneck
   64; 6 learned views of 224 x 224, so S = 196 + cls = 197 per view; 15
   classes; bf16) at full width and depth with seeded random weights (the
   adapters' up projections, view aggregation, cls token and pos too)
   serves requests of 1, 5, 32 and 256 clouds of 2048 points scaled into
   the unit sphere, on the kernel path and on the plain path; the logits
   must agree as above, and the serial-block, GEMM, LayerNorm and attention
   kernels must each launch. Both paths are timed at bucket 256, and the
   kernel path's forward is split by CUDA events into the view network,
   the render, patchify + pos, the 12 blocks and LN + aggregation + head.
6. Quantized APF serving: the ``slim2`` model with ``quantized=True``
   (dynamic w8a8: every encoder, qkv, proj, fc1 and fc2 product in int8)
   on the weights of step 2 serves the same requests on the kernel path and
   the plain path; the logits must agree as for the other models, the
   quant-dense, FPS, kNN and attention kernels must launch and the fused
   encoder and block must not. Its agreement with step 2's bf16 logits is
   printed (no bound), both paths are timed at bucket 256 beside step 2's
   kernel path, and the kernel path's forward is split by CUDA events into
   tokenizer, encoder, 12 blocks and head.
7. Holds each kernel against its plain version on the card at the shapes
   the main paths give it, and times both, beside the least time the card
   could take (``bound_ms``: the larger of the FLOPs over the H100's peak
   rate for their type and the bytes each input is read and each output
   written once over 3.35 TB/s) and, where one PyTorch call computes the
   same function, that call's time (``library_ms``; the port never calls
   it). The quant-dense kernel is held bit for bit at the eight int8
   product shapes of quantized serving, on the inputs the served model gave
   those layers, and timed beside ``torch._int_mm`` on the already
   quantized operands (the int8 product alone) and the bf16 GEMM kernel,
   with its row quantizer timed alone and its achieved TOP/s. The group
   encoder and the P3 stage (``csrc/group_mlp.cu``: a stack launch, one
   GEMM, a head launch) must also repeat bit for bit, and each is timed in
   turns beside the GEMM chain it replaced (``launch_chain``, which f32 and
   shapes off the kernels' gate still take) and launch by launch; the
   serving paths must have launched them, not the chains.
8. The fused attention sublayer: ``fused_attention_block`` forward and
   backward at the attention sublayers of the three served models (APF
   (256, 196, 768) x 12 heads, Pix4Point (256, 513, 384) x 6, renderer
   (1536, 197, 768) x 12), on block 0's first LayerNorm output and attention
   weights, with a seeded bf16 cotangent: the attn_block, GEMM and attention
   backward kernels must launch; the forward must agree with
   ``reference_attn_block``, and each of the five gradients must lie within
   the training gate of the plain path's and of an f32 run's. Timed beside
   ``torch.nn.MultiheadAttention`` on the same weights (never used).
9. Attention at S = 1024: APF slim2 with npoint 1024 serves one request of
   32 clouds of 2048 points on both paths (the serving gate; the fused
   block chain at the longest S it takes), then the attention forward and
   backward kernels are held against their plain versions on its block 0's
   qkv (32, 1024, 2304).
10. Attention above the blocks' gate: APF slim2 with npoint 1536 serves one
   request of 8 clouds of 4096 points on both paths (the serving gate; the
   blocks leave their fused chain for the unfused forward, as the JAX
   package does above S = 1024, so the attention kernel launches as
   mha_qkv and the fused block never), then the attention kernel is held
   against its plain version on its block 0's qkv (8, 1536, 2304).
11. The attention backward kernel at five shapes: block 0's qkv of APF
   (256, 196, 2304), the renderer (1536, 197, 2304), Pix4Point (256, 513,
   1152; 6 heads) and of steps 9 and 10 (S = 1024 and 1536), with a seeded
   bf16 cotangent: dq, dk and dv each within 2^-6 of its own max|ref| of
   the plain version, two runs bit-equal, timed beside its bound and SDPA's
   backward (timed only) with its achieved TFLOP/s.
12. The bf16 GEMM (``csrc/gemm.cu``) at each distinct product of the
   served renderer's serial-adapter block 0 (qkv, proj with the f32 sum and
   the bf16 pre output, the adapter's down and up, fc1, fc2: M = 302,592),
   of the served APF block 0 (M = 50,176) and of the APF group encoder's
   GEMM chain (M = 802,816 grouped points), on the inputs those chains gave it: bf16 outputs
   within 2^-7 and f32 outputs within 2^-12 of max|ref| of the plain
   version, two runs bit-equal, timed beside its bound, its TFLOP/s, the
   plain version and ``torch.nn.functional.linear`` on the same bf16
   operands (cuBLAS, without the epilogue; timed only); also block 0's
   products of the served Pix4Point (qkv, fc1, fc2: M = 131,328) and of
   its P3 stage's chain. Every instance that can take a product (the ping-pong
   one, the two-block 128 x 128) is held and timed beside the one picked.
13. Row 8's split: block 0 of the served Pix4Point launch by launch
   (pos-LayerNorm, qkv, attention, proj + LN2 as one launch, fc1, fc2;
   proj and LN2 also as two launches), each timed beside its bound.
14. Pix4Point off the P3 kernel's shapes: one cloud of 1000 points and a
   bucket-8 request of 1004-point clouds (B S % 16 != 0): the P3 stage
   runs unfused, as in JAX (no p3_embed launch), the blocks on their
   kernels, logits held against the plain path.
15. f32 models (``bf16=False``): APF slim2 and Pix4Point vit_small each
   serve one request of 32 clouds on the kernel path (the f32 GEMM, the
   f32 LayerNorms, the attention for any head dim) and the plain path:
   logits within 1 % of the largest, argmax equal on 99 % of clouds; the
   bf16 GEMM and attention must not launch.
16. A head dim 16 model (benchmarks/train_step_bench.py's small config:
   E 64, 4 heads, f32) at batch 256: one request served on both paths,
   then three training steps on both paths (first loss within 1e-4,
   gradients within 1e-3 relative L2); the any-head-dim attention forward
   and backward must launch. Then ``csrc/attention_any.cu`` alone, both
   directions, at head dims 8, 16, 32 and 128 in bf16 and f32, at the f32
   Pix4Point's and f32 APF's block 0 and at the head dim 16 model's: out,
   dq, dk and dv each against its own max|ref| of the plain version (f32
   within 2^-12, bf16 within 2^-6), two runs bit-equal, timed beside its
   bound (3xTF32 at the TF32 rate for f32), its TFLOP/s and SDPA forward
   and backward on the same inputs (timed only).
17. The blocks keep their launch-ready weights: the re-cast that each
   request no longer makes is timed per model.
18. Groups of 24 rows (fault C5): APF ``slim_k24`` (E=768, nsample 24,
   encoder second width 768, bf16) at full width and depth with seeded
   random weights serves one request of 32 clouds on both paths (the
   serving gate); its groups, padded with copies of their first row to 32,
   take the encoder's GEMM chain, which must launch. The group encoder at
   nsample 24 on slim2's widths (the group-MLP kernels, groups padded to
   32) is held against its plain version and timed beside nsample 32.
19. FPS (``csrc/fps.cu``) at the five shapes the paths give it: APF
   requests of 1, 5 and 256 clouds of 1024 points (196 samples), Pix4Point's
   bucket 256 (2048 points, 512) and APF at npoint 1536 (8 clouds of 4096
   points): indices equal to the plain version's and across two runs, the
   time and the time a step beside the bound and the plain version's.
20. ``serving_io``, right after step 2, on step 2's slim2 at full width and
   depth. (a) Checkpoints: the weights as a JAX-format checkpoint
   (``state_dict_to_flax``: params, batch_stats, the opt_state of APF's
   masked AdamW in the JAX trainer's optax layout (``adamw_to_optax``),
   EMA trees = the weights times 1 + 2 % seeded noise, a sidecar whose
   model_config rebuilds slim2) and as a port ``.pt`` checkpoint with an
   "ema" dict (the trainable parameters and BatchNorm statistics), written
   by ``save_checkpoint``; ``InferenceSession.from_checkpoint`` serves each
   bit-equal, at requests of 1, 32 and 256, to a session over a model
   loaded from the EMA trees, and with ``use_ema=False`` from the raw
   ones; write and read seconds and sizes printed. (b) Export:
   ``export_forward`` on the card, ``save_exported``,
   ``InferenceSession.from_exported`` over the bucket ladder: requests 1,
   5, 32, 256 within the serving gate of the live session's (bit-equality
   printed), every serving counter raised and the encoder's GEMM chain
   not; export seconds, bytes and a bucket-256 request from the artifact
   beside the live session's. Then Pix4Point, the renderer (learned views)
   and quantized APF at depth 2 and full width, each artifact within the
   gate of its live model, launching rows 7 and 8, 9 and 10. (c) HTTP:
   ``make_server(port=0)`` over the checkpoint's session on 127.0.0.1: 64
   threads each POST one cloud to /v1/classify (.npy both ways), one
   /v1/classify_batch of 256 clouds as JSON and one as .npy, every logit
   within the serving gate of ``predict_logits`` on the same clouds;
   /v1/health 200, a cloud of 4 channels 400, an oversized body 413;
   clouds/s printed, and how the clients' clouds coalesced.
21. ``ingest``, after step 20: weights and state from outside the port,
   with ``POINTVIT_WEIGHTS`` on a temporary cache. (a) Hub files, seeded:
   a timm ``vit_base_patch16_224`` ``.pth`` in bf16 (with the timm head,
   which APF ignores), a timm ``vit_small_patch16_384.augreg_in21k_ft_in1k``
   ``.npz`` and a torchvision ``vit_b_16`` in the HuggingFace layout as
   ``.safetensors`` (written by ``write_safetensors``): each loaded on the
   card into its model (train_apf.py's APF, also with
   ``reference_quirks``; Pix4Point vit_small; the renderer vit_b_16), the
   count equal to the JAX loader's (``HUB_COUNTS``), every mapped tensor
   bit-equal to the file after its re-layout (the mapping restated by
   ``hub_pairs``) and nothing else changed. (b) train_apf.py's model
   (``exact``: in_channels 4, nsample 32, encoder second width 1536; its
   encoder takes the GEMM chain) loaded from the ``.pth`` and trained on
   the kernel and the plain path, 7 steps of 32 clouds of 2048 points
   (xyz + height): the EMA starts at the loaded weights, the first loss
   within the training gate, the frozen trunk bit-equal to the file after
   the steps, the training kernels launched, ms/step printed. (c) Seeded
   reference ``torch.save`` files (``reference_state_dict``) of APF exact,
   Pix4Point vit_small and the renderer vit_b_16 with learned views, each
   served by ``Classifier.for_family(reference_checkpoint=)`` on the card,
   32 clouds, within the serving gate of the plain path loaded from the
   same file with nothing missing; build seconds and ms per request. (d)
   slim2 trained 3 steps at batch 64, written as a JAX trainer's msgpack
   (``adamw_to_optax``: the masked AdamW's optax layout), resumed by a
   fresh ``Trainer`` and trained 3 more: weights, BatchNorm statistics,
   EMA and Adam state bit-equal to the same run carried on without a stop.
22. ``parallel``, after step 21. (a) The MoE Pix4Point trunk:
   ``train_pix4point.py``'s model with ``moe_experts`` 4, ``moe_every`` 2,
   top-2 (blocks 1, 3, …, 11 are MoE blocks; capacity factor 2), bf16, at
   full width and depth with seeded weights, serves requests of 1, 32 and
   256 clouds of 2048 points on the kernel and the plain path (the serving
   gate; FPS, kNN, the P3 stage, the dense blocks' chain and the MoE
   blocks' attention must launch), bucket 256 timed and profiled; then 5
   training steps of 64 x 2048 clouds on both paths with
   ``pix4point_optimizer``, an f32 first step (with the trainer's 0.01 x
   aux loss) as the gradient reference, held by the training gates, every
   router gradient nonzero on both paths and in f32; the routers' first-step
   gradients held by the same gates on one routing (the plain path and the
   f32 run again on the kernel path's expert picks; the share of picks that
   differ printed); one step profiled with the expert FFN's forward and
   backward in ``record_function`` ranges (their share of the step's kernel
   time), and one block's expert FFN timed alone at the step's widest
   buffer. (b) A world-1 NCCL group (a
   ``FileStore`` in a temporary directory): slim2 trained 3 steps at 64 x
   1024 by ``Trainer()``, ``Trainer(mesh=make_mesh())`` (DDP) and
   ``Trainer(mesh=..., fsdp=True)`` (FSDP2), each bit for bit against the
   one-process run or within 1e-6 relative after the last step (the case
   printed); the FSDP trainer's checkpoint
   served by a session with no mesh and the trained model by a session
   with a mesh, requests 1/32/256, against a session without one;
   ``batch_shard_map`` over the attention (row 5) and group encoder (row
   3) wrappers against the direct calls, bit for bit.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero; without a CUDA device it exits 1 before doing anything. It imports
nothing of JAX and nothing of the JAX package ``pointvit_tpu``. The paths run
at full depth; the whole run takes about five minutes of command time, the
kernels' build (all sources in parallel) one to two.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
POINTS = 1024
REQUESTS = (1, 5, 32, 256)
ARGMAX_AGREEMENT = 0.99
# Kernel chain vs plain version, both bf16 with the same rounding points:
# they differ only in f32 summation order, which moves a bf16 rounding by
# one step (2^-8 relative) here and there. Bound on max|Δ| / max|ref|.
BF16_REL_TOL = 2.0**-6
# Logits after 12 bf16 blocks: the per-op differences above compound.
LOGIT_REL_TOL = 0.05

# Training: slim2 with 15 classes, as benchmarks/train_step_bench.py arm slim2.
TRAIN_BATCH, TRAIN_CLASSES = 256, 15
WARMUP_STEPS, TIMED_STEPS = 2, 5
LR, WEIGHT_DECAY, LABEL_SMOOTHING = 5e-4, 5e-2, 0.3
# The two training paths run identical code except the attention forward
# and backward (kernel vs plain, both bf16 with the same rounding points).
# In bf16 the APF trunk's double residual doubles the token stream in every
# block, so bf16 rounding of the stream is large against each block's
# branch: on the card both bf16 paths' first-step gradients lie 0.2-0.45
# (relative L2) from an f32 run of the same step, and 0.1-0.25 from each
# other (batch 64). The kernel path is therefore held to the plain path and
# to that f32 reference. Bounds, set from those runs before the final one:
TRAIN_LOSS_REL_TOL = 5e-3   # first loss, |Δ| / |plain| (seen: 3.7e-5 at batch 256, 5e-4 at 64)
TRAIN_GRAD_REL_TOL = 0.5    # each trainable gradient vs the plain path's, relative L2
# ... and no further from the f32 gradient than the plain path is, within
# this factor (seen: at most 1.25 for tensors of 64 or more elements).
TRAIN_GRAD_F32_RATIO = 1.5
# The 12 one-element adapter scales are held only through all gradients
# taken together: each is one sum over the whole batch that nearly cancels,
# so both bf16 paths are several times their own size from f32 there.
# A bias that feeds a train-mode BatchNorm (and the final norm's bias) has
# an exactly zero gradient; both paths give rounding noise there, held
# against the global gradient norm instead (seen: 0.0076).
TRAIN_ZERO_GRAD_TOL = 0.05
PRE_BN_BIASES = ("first_0.bias", "first_1.bias", "first_2.bias", "second_0_global.bias",
                 "head.fc0.bias", "head.fc1.bias", "encoder_norm.bias")
# Trainable parameters after the 7 steps, relative L2 norm per tensor: Adam
# moves every element by about lr per step whatever its gradient's size, so
# elements whose gradients the bf16 noise above flips move the other way
# (seen: at most 0.045).
TRAIN_PARAM_REL_TOL = 0.1

# Pix4Point serving: the model_config of train_pix4point.py, in bf16.
P4P_CONFIG = {
    "model_name": "Pix4Point", "num_classes": 15,
    "pretrained_model": "vit_small_patch16_384.augreg_in21k_ft_in1k", "pretrained": True,
    "frozen": False, "k_neighbors": 16, "embed_dim": 384, "bf16": True,
}
P4P_POINTS, P4P_TOKENS = 2048, 512

# Pix4Point training: the train_config of train_pix4point.py (batch 64 of
# 2048-point clouds; warm-up then cosine, clip 10), from seeded weights.
P4P_TRAIN_CONFIG = {"batch_size": 64, "learning_rate": 5e-4, "weight_decay": 5e-2, "t_max": 100,
                    "warmup_epochs": 10, "min_lr": 1.0e-6, "grad_norm_clip": 10}

# The parallel phase. (a) The MoE trunk: train_pix4point.py's model with every
# second block's MLP widened to 4 experts, top-2 (capacity factor 2.0, the
# default), served and trained as Pix4Point is; the serving kernels of the
# dense blocks and the MoE blocks' attention must launch.
MOE_KEYS = {"moe_experts": 4, "moe_every": 2, "moe_top_k": 2}
MOE_REQUESTS = (1, 32, 256)
MOE_TRAIN_STEPS = WARMUP_STEPS + TIMED_STEPS - 2  # 5: two untimed, three timed
MOE_SERVE_COUNTERS = ("fps", "knn", "p3_embed", "vit_block", "mha_qkv")
# The routers' first-step gradients are held on one routing
# (moe_router_gates): a pick that bf16 rounding moves to another expert sends
# that token's router gradient to another column, so the kernel path is held
# against the plain path and f32 run on the kernel path's picks.
# (b) World-1 NCCL: APF slim2 trained this many steps at this batch under
# each layout.
PARALLEL_STEPS, PARALLEL_BATCH = 3, 64

# Renderer serving: the model_config of train_renderer.py, in bf16.
RENDERER_CONFIG = {
    "num_classes": 15, "vit_name": "vit_b_16", "adapter_dim": 64, "num_views": 6,
    "img_size": 224, "pretrained": True, "dropout_rate": 0.1, "diff_renderer": True,
    "view_transform_hidden": 256, "bf16": True,
}
RENDERER_POINTS = 2048

# Renderer training: the train_config of train_renderer.py (batch 16 of
# 2048-point clouds, so 96 images a step; constant lr 5e-4, wd 5e-2 on every
# trainable tensor, no clip), from seeded weights.
RENDERER_TRAIN_CONFIG = {"batch_size": 16, "min_lr": 1e-6, "learning_rate": 5e-4, "weight_decay": 5e-2,
                         "epochs": 100, "use_lr_scheduler": False, "clip_grad_norm": 0.0}
# Its biases whose gradient is exactly zero: each feeds a train-mode BatchNorm.
RENDERER_PRE_BN_BIASES = tuple(f"view_transform_net.enc{i}.bias" for i in range(3))
# Training runs the 12 blocks unfused (the attention forward and backward
# kernels, once a block and step each: the images carry a gradient into
# block 0) and the patchify as a plain product with autograd, as JAX does.
RENDERER_TRAIN_COUNTERS = ("mha_qkv", "mha_qkv_bwd")
RENDERER_TRAIN_UNUSED = ("serial_block", "gemm", "layernorm", "attention", "fps", "knn")

# APF slim2 at the JAX package's longest fused sequence: npoint 1024 over
# 2048-point clouds, one bucket-32 request (the fused block chain).
LONG_NPOINT, LONG_BATCH = 1024, 32
# APF slim2 above that gate: npoint 1536 over 4096-point clouds, one request
# of 8 (the unfused block, whose attention kernel takes any S).
LONGER_NPOINT, LONGER_BATCH, LONGER_POINTS = 1536, 8, 4096

# f32 serving (APF slim2 and Pix4Point vit_small, bf16=False): one request
# of F32_BATCH clouds each. Kernel and plain path are both f32 and differ in
# summation order only, far below these bounds (the models' gates).
F32_BATCH = 32
F32_LOGIT_REL_TOL = 0.01
# f32 kernels against their plain versions: f32 summation order only.
F32_REL_TOL = 2.0**-12
# The head dim 16 model: benchmarks/train_step_bench.py's small config (E 64,
# 4 heads, npoint 32, depth 2, second width 64, f32, 256 points; slim2's
# nsample 16) at the slice's batch of 256, 15 classes.
SMALL_CONFIG = dict(num_classes=15, in_channels=3, embedding_dim=64, npoint=32, nsample=16, depth=2,
                    num_heads=4, encoder_second_width=64)
SMALL_POINTS, SMALL_STEPS = 256, 3
F32_LOSS_REL_TOL, F32_GRAD_REL_TOL = 1e-4, 1e-3
# csrc/attention_any.cu held alone at these head dims, both dtypes, on
# (ANY_BATCH, ANY_SEQ, 3 ANY_WIDTH) seeded inputs.
ANY_HEAD_DIMS, ANY_BATCH, ANY_SEQ, ANY_WIDTH = (8, 16, 32, 128), 32, 197, 384
# Pix4Point off the P3 kernel's shapes: (clouds, points) with B S % 16 != 0.
P4P_OFF_SHAPES = ((1, 1000), (8, 1004))
# The grouping op above the kNN list instance's k (64): Pix4Point's first
# grouping (512 centres of 2048 points) with this many neighbours takes the
# rows instance.
KNN_WIDE_K = 96

# The H100 SXM's published peaks (dense): the bound of a kernel is the larger
# of its FLOPs over the rate for their type and its bytes over HBM's rate.
PEAK_BF16, PEAK_F32, PEAK_INT8, HBM_BPS = 989e12, 67e12, 1979e12, 3.35e12
# TF32 on the tensor cores: csrc/attention_any.cu computes each f32 product
# as three TF32 products (3xTF32), so its f32 bound is 3 x FLOPs at this.
PEAK_TF32 = 494.7e12

KERNELS = {
    "fps": ("pointvit_tpu_torch/csrc/fps.cu", "pointvit_tpu/ops/pallas_fps.py:78"),
    "knn": ("pointvit_tpu_torch/csrc/knn.cu", "pointvit_tpu/ops/pallas_knn.py:109"),
    "knn_rows": ("pointvit_tpu_torch/csrc/knn.cu", "pointvit_tpu/ops/pallas_knn.py:109"),
    "group_encoder": ("pointvit_tpu_torch/csrc/group_mlp.cu", "pointvit_tpu/ops/pallas_encoder.py:93"),
    "apf_block": ("pointvit_tpu_torch/csrc/block.cu", "pointvit_tpu/ops/pallas_block.py:197"),
    "mha_qkv": ("pointvit_tpu_torch/csrc/attention.cu", "pointvit_tpu/ops/pallas_attention.py:205"),
    "mha_qkv_bwd": ("pointvit_tpu_torch/csrc/attention_bwd.cu",
                    "pointvit_tpu/ops/pallas_attention.py:399"),
    "p3_embed": ("pointvit_tpu_torch/csrc/group_mlp.cu", "pointvit_tpu/ops/pallas_encoder.py:235"),
    "vit_block": ("pointvit_tpu_torch/csrc/block.cu", "pointvit_tpu/ops/pallas_block.py:338"),
    "serial_block": ("pointvit_tpu_torch/csrc/gemm.cu", "pointvit_tpu/ops/pallas_block.py:508"),
    "quant_dense": ("pointvit_tpu_torch/csrc/quant.cu", "pointvit_tpu/ops/pallas_quant.py:60"),
    "attn_block": ("pointvit_tpu_torch/csrc/attn_block.cu",
                   "pointvit_tpu/ops/pallas_attention.py:508"),
    "attention_any": ("pointvit_tpu_torch/csrc/attention_any.cu",
                      "pointvit_tpu/ops/pallas_attention.py:205"),
    "attention_any_bwd": ("pointvit_tpu_torch/csrc/attention_any.cu",
                          "pointvit_tpu/ops/pallas_attention.py:399"),
    "gemm_f32": ("pointvit_tpu_torch/csrc/gemm.cu", "pointvit_tpu/ops/pallas_block.py:338"),
    "gemm_pingpong": ("pointvit_tpu_torch/csrc/gemm.cu", "pointvit_tpu/ops/pallas_block.py:338"),
    "proj_layernorm": ("pointvit_tpu_torch/csrc/gemm.cu", "pointvit_tpu/ops/pallas_block.py:338"),
}
# The keys of every entry of the kernels line, and the shape it was measured
# at: every number on it is measured in this run, but bound_ms.
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms", "shape"}
# The counters each path must raise: the ports and the kernels they chain.
# In bf16 the encoder and the P3 stage take the group-MLP kernels (a stack
# launch, one GEMM, a head launch) and never their GEMM chains.
GROUP_MLP_COUNTERS = ("group_stack", "group_head")
SERVING_COUNTERS = ("fps", "knn", "group_encoder", *GROUP_MLP_COUNTERS, "apf_block", "gemm", "layernorm",
                    "attention")
TRAINING_COUNTERS = ("fps", "knn", "mha_qkv", "mha_qkv_bwd")
# Pix4Point training raises the same counters and leaves the fused P3 stage
# and blocks, as the JAX package does (nn/pointnet.py:168-171,
# nn/vit.py:70-71).
P4P_TRAIN_UNUSED = ("p3_embed", "p3_embed_chain", *GROUP_MLP_COUNTERS, "vit_block", "proj_layernorm",
                    "pos_layernorm")
# Its biases whose gradient is exactly zero: each feeds a train-mode
# BatchNorm (the final norm's reaches the head's first as a constant).
P4P_PRE_BN_BIASES = ("s0_conv1_1.bias", "cls_head.fc0.bias", "cls_head.fc1.bias", "model.norm.bias")
P4P_COUNTERS = ("fps", "knn", "p3_embed", *GROUP_MLP_COUNTERS, "vit_block", "gemm", "proj_layernorm",
                "pos_layernorm", "attention")
CHAIN_COUNTERS = ("group_encoder_chain", "p3_embed_chain")
RENDERER_COUNTERS = ("serial_block", "gemm", "layernorm", "attention")
# Quantized APF serving: the int8 products, the tokenizer and the attention
# forward (B5, counted as mha_qkv) launch; the fused encoder and block do not.
QUANT_COUNTERS = ("quant_dense", "fps", "knn", "mha_qkv")
# The quantized paths differ only in the attention kernel's summation order,
# and each int8 quantizer turns a one-step bf16 difference of a large input
# into a one-step int8 difference. On an H100 80GB HBM3 (700 W) the served
# bf16 logits of 3 of 294 clouds then change argmax, each a cloud whose two
# top plain-path logits lie 1-2 bf16 steps apart (over 1 % of these clouds
# tie exactly).
# So argmax agreement is counted over the clouds that are not such ties:
# top-2 gap above BF16_REL_TOL x max|logit| (2^-6 relative, a few bf16
# steps; the two paths' logits differ by up to three). APF with npoint 1024
# (one request of 32 clouds) is held the same way: on that card 2 of its 32
# clouds changed argmax with max|dlogit| at two bf16 steps, the size of
# difference the main APF phase shows.
QUANT_UNUSED = ("apf_block", "group_encoder", "group_encoder_chain")
# The int8 layers held in the quant-dense kernel phase (the encoder's and
# block 0's), in the order of the forward; fc1 goes on the kernels line.
QUANT_LAYERS = ("point_encoder.first_1", "point_encoder.first_2", "point_encoder.second_0_local",
                "point_encoder.second_1", "blocks.0.attention.qkv", "blocks.0.attention.proj",
                "blocks.0.mlp.fc1", "blocks.0.mlp.fc2")
QUANT_LINE_LAYER = "blocks.0.mlp.fc1"


# The GEMM phase (csrc/gemm.cu at each distinct product of the serial and
# APF block chains and the group encoder): kernel and plain version differ
# only in f32 summation order, so a bf16 output (out, pre, gmax) moves by at
# most one bf16 step (2^-7 of max|ref| bounds it) and an f32 output by a few
# f32 ulps of the sums (2^-12 of max|ref|); two runs give the same bits.
GEMM_BF16_REL_TOL, GEMM_F32_REL_TOL = 2.0**-7, 2.0**-12


# The distinct products of each chain, in the order the chain first calls them.
SERIAL_GEMMS = ("qkv", "proj", "dn", "up", "fc1", "fc2")
APF_GEMMS = ("qkv", "proj", "fc1", "dn", "up", "fc2")
VIT_GEMMS = ("qkv", "fc1", "fc2")  # proj runs with LN2 as one launch (vit_split)
P3_GEMMS = ("x.W01 (max per group)", "g.W2g", "h.W2l", "h2.W3 (max per group)")
ENCODER_GEMMS = ("first_0", "first_1", "first_2 (max per group)", "second_0_global",
                 "second_0_local", "second_1 (max per group)")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    """The least time the card could take: FLOPs at ``peak`` or bytes at
    HBM's rate, whichever is longer."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def randomize(torch, model, gen) -> None:
    """Seeded random weights. BN statistics (positive variances), the
    adapter up-projection and scale, the LN affines and the cls token and
    pos are random too: the zero-init up-projection and unit statistics
    would hide kernel faults."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                v = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
            elif name.endswith("adapter.scale"):
                v = 0.5 + torch.rand(p.shape, generator=gen)
            elif name.endswith("weight"):  # LayerNorm / BatchNorm gamma
                v = 1.0 + 0.2 * torch.randn(p.shape, generator=gen)
            else:
                v = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(v)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))


def rel_err(torch, got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def untied(got: np.ndarray, want: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per cloud: whether the two paths' argmax agree, the plain path's
    top-2 gap, and whether that gap exceeds BF16_REL_TOL x max|logit| (a
    cloud the paths' rounding-order differences cannot flip)."""
    same = got.argmax(-1) == want.argmax(-1)
    top2 = np.sort(want, -1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    return same, gap, gap > BF16_REL_TOL * float(np.abs(want).max())


def shape_clouds(rng, n: int, classes: int, points: int = POINTS) -> tuple[np.ndarray, np.ndarray]:
    """Seeded class-separable clouds: class c is a zero-mean Gaussian with
    its own per-axis scales, rotated at random per cloud."""
    scales = 0.3 + 0.7 * rng.random((classes, 3))
    labels = rng.integers(0, classes, n)
    pts = rng.standard_normal((n, points, 3)) * scales[labels][:, None, :]
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    return np.einsum("npi,nij->npj", pts, q).astype(np.float32), labels


def train_phase(torch, dev, _build) -> dict:
    """Both training paths on the same seeded weights, batches and draws."""
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config, apf_trainable_mask
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule

    cfg = apf_preset_config("slim2", num_classes=TRAIN_CLASSES)  # dropout, drop-path 0.1
    models = {"kernel": AdaptPointFormer(**cfg), "plain": AdaptPointFormer(**cfg, implementation="torch")}
    randomize(torch, models["kernel"], torch.Generator().manual_seed(SEED + 1))
    models["plain"].load_state_dict(models["kernel"].state_dict())
    init = {n: p.detach().clone() for n, p in models["kernel"].named_parameters()}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trainers = {}
    for path, model in models.items():
        sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=5, warmup_lr_init=1e-3)
        opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY,
                              trainable_mask=apf_trainable_mask(model))
        trainers[path] = Trainer(
            model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
            batch_size=TRAIN_BATCH, epochs=1, label_smoothing=LABEL_SMOOTHING,
            output_dir=out_dir, seed=SEED, device=dev, train_loader=[], test_loader=[],
            save_config_snapshot=False,
        )
    shutil.rmtree(out_dir)
    trainable = sorted(apf_trainable_mask(models["kernel"]))
    rng = np.random.default_rng(SEED + 1)
    batches = []  # steps 1..WARMUP_STEPS warm up, the rest are timed
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        pts, lbl = shape_clouds(rng, TRAIN_BATCH, TRAIN_CLASSES)
        batches.append((torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)))

    f32 = first_step_grads(torch, AdaptPointFormer(**{**cfg, "dtype": torch.float32}, implementation="torch"),
                         models["kernel"], trainable, batches[0], LABEL_SMOOTHING, dev)
    res = train_paths(torch, _build, trainers, batches, trainable)
    res["grads"]["f32"] = f32
    check_training(torch, "train", res, models, init, trainable, PRE_BN_BIASES, TRAINING_COUNTERS)
    print(f"train step at batch {TRAIN_BATCH}: {step_line(res, TRAIN_BATCH)}", flush=True)
    del trainers, models
    torch.cuda.empty_cache()
    return res


def first_step_grads(torch, ref, model, trainable, batch, smoothing, dev) -> dict:
    """The first step's gradients, unclipped: ``ref`` (the f32 reference is
    the plain path in f32) on ``model``'s weights takes the first batch with
    the trainers' draws (a generator seeded as theirs are) and the trainers'
    loss; returns its trainable gradients."""
    from pointvit_tpu_torch.train import cross_entropy_loss, set_trainable

    ref.load_state_dict(model.state_dict())
    set_trainable(ref, trainable)
    ref = ref.to(dev)
    logits = ref(batch[0], train=True, generator=torch.Generator(device=dev).manual_seed(SEED))
    loss = cross_entropy_loss(logits, batch[1], smoothing).mean()
    if getattr(ref, "moe_experts", 0):  # the trainer's loss: + 0.01 x the router aux loss
        from pointvit_tpu_torch.nn.moe import collect_moe_aux_loss

        loss = loss + 0.01 * collect_moe_aux_loss(ref).to(loss.device)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in ref.named_parameters() if n in trainable}
    del ref, logits
    torch.cuda.empty_cache()
    return grads


def train_paths(torch, _build, trainers, batches, trainable) -> dict:
    """The trainers (kernel and plain path) take the same batches: the
    first WARMUP_STEPS untimed, keeping each path's first-step gradients of
    the ``trainable`` tensors, then the rest timed by CUDA events, with the
    kernel path's launch counts over the timed steps and the peak device
    memory of the steps."""
    torch.cuda.reset_peak_memory_stats()
    res = {"losses": {}, "ms": {}, "grads": {}}
    for path, tr in trainers.items():
        loss, _, _ = tr.train_step(*batches[0])
        res["losses"][path] = [loss]
        res["grads"][path] = {n: p.grad.detach().clone()
                              for n, p in tr.model.named_parameters() if n in trainable}
        for b in batches[1:WARMUP_STEPS]:
            res["losses"][path].append(tr.train_step(*b)[0])
    for path, tr in trainers.items():
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for b in batches[WARMUP_STEPS:]:
            res["losses"][path].append(tr.train_step(*b)[0])
        t1.record()
        torch.cuda.synchronize()
        res["ms"][path] = t0.elapsed_time(t1) / (len(batches) - WARMUP_STEPS)
        if path == "kernel":
            res["counts"] = _build.launch_counts()
    res["losses"] = {k: [v.item() for v in vs] for k, vs in res["losses"].items()}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def check_training(torch, label, res, models, init, trainable, zero, counters, unused=(),
                   apart=()) -> None:
    """The training gates on ``train_paths``' result: finite losses, the
    first loss and each trainable first-step gradient of the kernel path
    against the plain path's and an f32 run's (``res['grads']['f32']``;
    ``zero`` names the biases whose gradient is exactly zero), the trainable
    parameters after the last step against each other and moved from
    ``init``, frozen parameters bit-unchanged, the ``counters`` launched
    during the timed steps and the ``unused`` not. The first-step gates
    leave out the tensors ``apart`` (the MoE routers, which
    ``moe_router_gates`` holds on one routing)."""
    lk, lp = res["losses"]["kernel"], res["losses"]["plain"]
    print(f"{label} losses: kernel path {lk}, plain path {lp}", flush=True)
    if not all(np.isfinite(lk + lp)):
        fail(f"a {label} loss is not finite")
    d = abs(lk[0] - lp[0]) / abs(lp[0])
    print(f"{label}: first loss |d| / |plain| {d:.3g} (bound {TRAIN_LOSS_REL_TOL})", flush=True)
    if not d <= TRAIN_LOSS_REL_TOL:
        fail(f"the first {label} loss disagrees between the kernel and plain paths")
    gk, gp, gf = (res["grads"][k] for k in ("kernel", "plain", "f32"))
    worst_grad, worst_zero, tensors, live = grad_gates(
        torch, [n for n in trainable if n not in apart], gk, gp, zero)
    flat = lambda g: torch.cat([g[n].float().flatten() for n in live])  # noqa: E731
    total = flat(gp).norm().item()
    worst_ratio = max((rel_l2(gk[n], gf[n]) / rel_l2(gp[n], gf[n]), n) for n in tensors)
    ek, ep = rel_l2(flat(gk), flat(gf)), rel_l2(flat(gp), flat(gf))
    print(f"{label}: first-step gradients, {len(tensors)} trainable tensors: kernel vs plain path "
          f"worst relative L2 {worst_grad[0]:.3g} ({worst_grad[1]}; bound {TRAIN_GRAD_REL_TOL}); "
          f"(kernel vs f32) / (plain vs f32) worst {worst_ratio[0]:.3g} ({worst_ratio[1]}; bound "
          f"{TRAIN_GRAD_F32_RATIO}); all {len(live)} together: kernel vs f32 {ek:.3g}, plain vs "
          f"f32 {ep:.3g}, kernel vs plain {rel_l2(flat(gk), flat(gp)):.3g}; "
          f"{len(trainable) - len(live)} exactly-zero "
          f"gradients at most {worst_zero[0]:.3g} of the global norm {total:.4g} ({worst_zero[1]}; "
          f"bound {TRAIN_ZERO_GRAD_TOL})", flush=True)
    if not (worst_grad[0] <= TRAIN_GRAD_REL_TOL and worst_ratio[0] <= TRAIN_GRAD_F32_RATIO
            and ek <= TRAIN_GRAD_F32_RATIO * ep and worst_zero[0] <= TRAIN_ZERO_GRAD_TOL):
        fail(f"first-step {label} gradients of the kernel path disagree with the plain path's or f32's")
    dev = next(iter(models["kernel"].parameters())).device
    pk, pp = dict(models["kernel"].named_parameters()), dict(models["plain"].named_parameters())
    worst_param = max((rel_l2(pk[n], pp[n]), n) for n in trainable)
    moved = min(rel_l2(pp[n], init[n].to(dev)) for n in trainable)
    print(f"{label}: trainable parameters after {len(lk)} steps: worst "
          f"relative L2 between the paths {worst_param[0]:.3g} ({worst_param[1]}; bound "
          f"{TRAIN_PARAM_REL_TOL}); smallest move from the init {moved:.3g}", flush=True)
    if not worst_param[0] <= TRAIN_PARAM_REL_TOL or not moved > 0:
        fail(f"{label}: trainable parameters disagree between the paths after training, or did not move")
    for path, m in models.items():
        for n, p in m.named_parameters():
            if n not in trainable and not torch.equal(p.detach().cpu(), init[n]):
                fail(f"{label}: the {path} path changed the frozen parameter {n}")
    print(f"{label}: {len(init) - len(trainable)} frozen tensors bit-unchanged on both paths",
          flush=True)
    print(f"{label} launches during the timed steps: {json.dumps(res['counts'])}", flush=True)
    for name in counters:
        if res["counts"].get(name, 0) <= 0:
            fail(f"the {label} path never launched the {name} kernel")
    for name in unused:
        if res["counts"].get(name, 0):
            fail(f"the {label} path launched the {name} kernel, which training leaves")


def step_line(res, batch) -> str:
    tk, tp = res["ms"]["kernel"], res["ms"]["plain"]
    return (f"kernel path {tk:.3f} ms/step ({batch * 1e3 / tk:.1f} clouds/s trained), plain path "
            f"{tp:.3f} ms/step ({batch * 1e3 / tp:.1f} clouds/s); peak device memory "
            f"{res['peak_gib']:.2f} GiB")


def grad_gates(torch, trainable, gk, gp, zero=PRE_BN_BIASES) -> tuple[tuple, tuple, list, list]:
    """Two paths' gradients (name -> tensor) over the trainable tensors:
    the worst relative L2 (value, name) over the tensors of more than one
    element, the largest exactly-zero gradient (the names ending in
    ``zero``: biases before a train-mode BatchNorm) relative to the plain
    path's global norm over the others, the tensors compared, and those
    others."""
    zero = [n for n in trainable if n.endswith(zero)]
    live = [n for n in trainable if n not in zero]
    total = torch.cat([gp[n].float().flatten() for n in live]).norm().item()
    worst_zero = max((max(gk[n].float().norm().item(), gp[n].float().norm().item()) / total, n)
                     for n in zero)
    tensors = [n for n in live if gp[n].numel() > 1]
    return max((rel_l2(gk[n], gp[n]), n) for n in tensors), worst_zero, tensors, live


def train_long_phase(torch, dev, _build) -> dict:
    """One APF slim2 training step at npoint 1536 (LONGER_BATCH clouds of
    LONGER_POINTS points), above the JAX package's Pallas gate for the
    attention backward (S <= 1024 at 12 heads), where JAX runs the
    recompute VJP and the port its backward kernel. The kernel path and the
    plain path take the same step from the same weights, batch and draws:
    the first loss and every trainable gradient are held to the training
    gates, and both attention kernels must launch. Returns the launch
    counts."""
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config, apf_trainable_mask
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule

    cfg = apf_preset_config("slim2", num_classes=TRAIN_CLASSES, npoint=LONGER_NPOINT)
    models = {"kernel": AdaptPointFormer(**cfg), "plain": AdaptPointFormer(**cfg, implementation="torch")}
    randomize(torch, models["kernel"], torch.Generator().manual_seed(SEED + 8))
    models["plain"].load_state_dict(models["kernel"].state_dict())
    trainable = sorted(apf_trainable_mask(models["kernel"]))
    rng = np.random.default_rng(SEED + 8)
    pts, lbl = shape_clouds(rng, LONGER_BATCH, TRAIN_CLASSES, LONGER_POINTS)
    pts, lbl = torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_long_")
    res = {"loss": {}, "grads": {}, "ms": {}}
    for path, model in models.items():
        sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=5, warmup_lr_init=1e-3)
        opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY,
                              trainable_mask=apf_trainable_mask(model))
        tr = Trainer(
            model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
            batch_size=LONGER_BATCH, epochs=1, label_smoothing=LABEL_SMOOTHING,
            output_dir=out_dir, seed=SEED, device=dev, train_loader=[], test_loader=[],
            save_config_snapshot=False,
        )
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, _ = tr.train_step(pts, lbl)
        torch.cuda.synchronize()
        res["ms"][path] = (time.perf_counter() - t0) * 1e3
        if path == "kernel":
            res["counts"] = _build.launch_counts()
        res["loss"][path] = loss.item()
        res["grads"][path] = {n: p.grad.detach().clone()
                              for n, p in tr.model.named_parameters() if n in trainable}
        del tr, opt
    shutil.rmtree(out_dir)
    lk, lp = res["loss"]["kernel"], res["loss"]["plain"]
    d = abs(lk - lp) / abs(lp)
    worst_grad, worst_zero, tensors, _ = grad_gates(torch, trainable, res["grads"]["kernel"],
                                                    res["grads"]["plain"])
    print(f"train npoint {LONGER_NPOINT}, {LONGER_BATCH} clouds of {LONGER_POINTS} points, one step: "
          f"loss kernel path {lk:.6g}, plain path {lp:.6g}, |d| / |plain| {d:.3g} (bound "
          f"{TRAIN_LOSS_REL_TOL}); gradients of {len(tensors)} trainable tensors, worst relative L2 "
          f"{worst_grad[0]:.3g} ({worst_grad[1]}; bound {TRAIN_GRAD_REL_TOL}); exactly-zero "
          f"gradients at most {worst_zero[0]:.3g} of the global norm ({worst_zero[1]}; bound "
          f"{TRAIN_ZERO_GRAD_TOL}); the step (each path's first, so with its one-time costs; host "
          f"clock, synchronised) kernel path "
          f"{res['ms']['kernel']:.3f} ms, plain path {res['ms']['plain']:.3f} ms", flush=True)
    print(f"train npoint {LONGER_NPOINT} launches: {json.dumps(res['counts'])}", flush=True)
    if not (np.isfinite([lk, lp]).all() and d <= TRAIN_LOSS_REL_TOL):
        fail(f"the npoint {LONGER_NPOINT} training loss disagrees between the paths")
    if not (worst_grad[0] <= TRAIN_GRAD_REL_TOL and worst_zero[0] <= TRAIN_ZERO_GRAD_TOL):
        fail(f"the npoint {LONGER_NPOINT} gradients of the kernel path disagree with the plain path's")
    for name in ("mha_qkv", "mha_qkv_bwd"):
        if res["counts"].get(name, 0) <= 0:
            fail(f"the npoint {LONGER_NPOINT} training step never launched the {name} kernel")
    del models
    torch.cuda.empty_cache()
    return res


def pix4point_train_phase(torch, dev, _build) -> dict:
    """Pix4Point training at full width and depth (``build_model`` of the
    ``train_pix4point.py`` config, bf16, seeded random weights): two
    ``Trainer``s, on the kernel path and on the plain path, built as
    ``Pix4PointTrainer`` builds its optimizer (``pix4point_optimizer``),
    take the same batches of P4P_TRAIN_CONFIG's 64 clouds of 2048 points
    with the same draws (FPS starts, then the head's dropouts), held as the
    APF phase is, with an f32 first step as the gradient reference. Then one
    kernel-path step split by CUDA events, and one step with the trunk
    frozen. Returns the launch counts of the timed steps."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.train import Trainer
    from pointvit_tpu_torch.train.pix4point_trainer import pix4point_optimizer

    cfg = {**P4P_CONFIG, "pretrained": False, "frozen": False}
    batch, classes = P4P_TRAIN_CONFIG["batch_size"], cfg["num_classes"]
    models = {"kernel": build_model(cfg), "plain": build_model(cfg, implementation="torch")}
    randomize(torch, models["kernel"], torch.Generator().manual_seed(SEED + 50))
    models["plain"].load_state_dict(models["kernel"].state_dict())
    init = {n: p.detach().clone() for n, p in models["kernel"].named_parameters()}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_p4p_train_")

    def trainer(model, frozen=False):
        # one step an epoch: the steps walk the warm-up
        sched, opt = pix4point_optimizer(model, P4P_TRAIN_CONFIG, 1, frozen=frozen)
        return Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                       batch_size=batch, epochs=1, label_smoothing=0.0, output_dir=out_dir, seed=SEED,
                       device=dev, train_loader=[], test_loader=[], save_config_snapshot=False)

    trainers = {path: trainer(model) for path, model in models.items()}
    trainable = sorted(n for n, p in models["kernel"].named_parameters() if p.requires_grad)
    rng = np.random.default_rng(SEED + 50)
    batches = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        pts, lbl = shape_clouds(rng, batch, classes, P4P_POINTS)
        batches.append((torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)))
    f32 = first_step_grads(torch, build_model({**cfg, "bf16": False}, implementation="torch"),
                         models["kernel"], trainable, batches[0], 0.0, dev)
    res = train_paths(torch, _build, trainers, batches, trainable)
    res["grads"]["f32"] = f32
    check_training(torch, "pix4point train", res, models, init, trainable, P4P_PRE_BN_BIASES,
                   TRAINING_COUNTERS, P4P_TRAIN_UNUSED)
    print(f"pix4point train step at batch {batch} of {P4P_POINTS} points: {step_line(res, batch)}",
          flush=True)
    del trainers["plain"], models["plain"]
    torch.cuda.empty_cache()

    vit = models["kernel"].model
    marks = [(vit.patch_embed, "pre"), (vit.patch_embed, "post"), (vit.blocks[-1], "post")]
    names = ("tokenizer_p3", "blocks", "head_loss", "backward", "optimizer")
    # a warm-up split: the allocator refills after the plain path
    train_step_split(torch, trainers["kernel"], *batches[0], marks, names)
    split = train_step_split(torch, trainers["kernel"], *batches[1], marks, names)
    print(f"pix4point train step by stage, kernel path (CUDA events, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}, sum {sum(split.values()):.3f}",
          flush=True)

    busy = device_time_by_kernel(torch, lambda: trainers["kernel"].train_step(*batches[2]))
    print(f"pix4point train step under torch.profiler, kernel path: {busy['wall_ms']:.3f} ms on the "
          f"host's clock, {busy['device_ms']:.3f} ms of kernels ({busy['device_ms'] / busy['wall_ms']:.1%} "
          f"busy) in {busy['launches']} launches; most device time: {json.dumps(busy['top'])}",
          flush=True)

    model = models["kernel"]
    tr = trainer(model, frozen=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, _, _ = tr.train_step(*batches[1])
    torch.cuda.synchronize()
    trunk = [n for n in before if n.startswith(("model.blocks.", "model.norm."))]
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    print(f"pix4point train, trunk frozen: loss {loss.item():.6g}; {len(trunk)} trunk tensors, "
          f"{len(set(trunk) & set(moved))} moved; {len(moved)} tensors moved", flush=True)
    if not np.isfinite(loss.item()) or set(trunk) & set(moved):
        fail("pix4point train with the trunk frozen changed a trunk tensor or lost its loss")
    if not {"model.cls_token", "cls_head.out.weight"} <= set(moved):
        fail("pix4point train with the trunk frozen did not move cls_token and the head")
    shutil.rmtree(out_dir)
    del tr, trainers, models, model
    torch.cuda.empty_cache()
    return res


def renderer_train_phase(torch, dev, _build) -> dict:
    """Renderer training at full width and depth (``build_model`` of the
    ``train_renderer.py`` config, bf16, seeded random weights, none left at
    zero): two ``Trainer``s, on the kernel path and on the plain path, built
    as ``RendererTrainer`` builds its optimizer (``renderer_optimizer``:
    constant lr, weight decay on every trainable tensor, no clip, only the
    adapters trained inside the ViT), take the same batches of
    RENDERER_TRAIN_CONFIG's 16 unit-sphere clouds of 2048 points with the
    same draws (the head's dropouts), held as the APF phase is, with an f32
    first step as the gradient reference; every view-network gradient but
    the three before its BatchNorms must be nonzero and finite on the kernel
    path (the loss reaches the camera angles through the frozen blocks, the
    patchify and the splat). Then one kernel-path step split by CUDA events
    and one under ``torch.profiler``. Returns the launch counts of the timed
    steps."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.train import Trainer
    from pointvit_tpu_torch.train.renderer_trainer import renderer_optimizer

    cfg = {**RENDERER_CONFIG, "pretrained": False}
    batch, classes = RENDERER_TRAIN_CONFIG["batch_size"], cfg["num_classes"]
    models = {"kernel": build_model(cfg), "plain": build_model(cfg, implementation="torch")}
    randomize(torch, models["kernel"], torch.Generator().manual_seed(SEED + 60))
    zero = [n for n, p in models["kernel"].named_parameters() if not p.detach().any()]
    if zero:
        fail(f"renderer parameters left at zero by randomize: {zero[:5]}")
    models["plain"].load_state_dict(models["kernel"].state_dict())
    init = {n: p.detach().clone() for n, p in models["kernel"].named_parameters()}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_renderer_train_")
    trainers = {}
    for path, model in models.items():
        sched, opt = renderer_optimizer(model, RENDERER_TRAIN_CONFIG, 1)
        trainers[path] = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt,
                                 schedule=sched, batch_size=batch, epochs=1, label_smoothing=0.0,
                                 output_dir=out_dir, seed=SEED, device=dev, train_loader=[],
                                 test_loader=[], save_config_snapshot=False)
    shutil.rmtree(out_dir)
    trainable = sorted(n for n, p in models["kernel"].named_parameters() if p.requires_grad)
    rng = np.random.default_rng(SEED + 60)
    batches = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        pts, lbl = shape_clouds(rng, batch, classes, RENDERER_POINTS)
        batches.append((torch.from_numpy(unit_sphere(pts)).to(dev), torch.from_numpy(lbl).to(dev)))
    f32 = first_step_grads(torch, build_model({**cfg, "bf16": False}, implementation="torch"),
                         models["kernel"], trainable, batches[0], 0.0, dev)
    res = train_paths(torch, _build, trainers, batches, trainable)
    res["grads"]["f32"] = f32
    check_training(torch, "renderer train", res, models, init, trainable, RENDERER_PRE_BN_BIASES,
                   RENDERER_TRAIN_COUNTERS, RENDERER_TRAIN_UNUSED)
    depth = len(models["kernel"].vit.encoder_layer)
    for name in RENDERER_TRAIN_COUNTERS:  # once a block and step, forward and backward
        if res["counts"][name] != depth * TIMED_STEPS:
            fail(f"renderer train: {res['counts'][name]} {name} launches in {TIMED_STEPS} steps, "
                 f"not {depth * TIMED_STEPS}")
    parts = {}  # where the bf16 paths' distance from f32 lies, by part of the model
    for part in ("view_transform_net.", "vit.", "view_aggregation", "classifier."):
        members = [n for n in trainable if n.startswith(part) and not n.endswith(RENDERER_PRE_BN_BIASES)]
        flat = {k: torch.cat([res["grads"][k][n].float().flatten() for n in members])
                for k in ("kernel", "plain", "f32")}
        parts[part.rstrip(".")] = {"kernel_vs_f32": round(rel_l2(flat["kernel"], flat["f32"]), 4),
                                   "plain_vs_f32": round(rel_l2(flat["plain"], flat["f32"]), 4),
                                   "f32_norm": round(flat["f32"].norm().item(), 4)}
    print(f"renderer train: first-step gradients by part, relative L2: {json.dumps(parts)}", flush=True)
    vtn = {n: g for n, g in res["grads"]["kernel"].items() if n.startswith("view_transform_net.")}
    dead = [n for n, g in vtn.items() if not torch.isfinite(g).all()
            or (not n.endswith(RENDERER_PRE_BN_BIASES) and not g.abs().max().item() > 0)]
    print(f"renderer train: {len(vtn)} view-network gradients on the kernel path, "
          f"{len(vtn) - len(RENDERER_PRE_BN_BIASES)} of them nonzero by design: "
          f"{'all nonzero and finite' if not dead else 'zero or not finite: ' + ', '.join(dead)}",
          flush=True)
    if dead or len(vtn) <= len(RENDERER_PRE_BN_BIASES):
        fail("renderer train: the loss did not reach the view network on the kernel path")
    images = batch * cfg["num_views"]
    print(f"renderer train step at batch {batch} of {RENDERER_POINTS} points ({images} images of "
          f"{cfg['img_size']}²): {step_line(res, batch)}", flush=True)
    del trainers["plain"], models["plain"]
    torch.cuda.empty_cache()

    model = models["kernel"]
    marks = [(model.view_transform_net, "pre"), (model.view_transform_net, "post"),
             (model.vit.conv_proj, "pre"), (model.vit.encoder_layer[0], "pre"),
             (model.vit.encoder_layer[-1], "post")]
    names = ("view_net", "render", "patchify_pos", "blocks", "head_loss", "backward", "optimizer")
    # a warm-up split: the allocator refills after the plain path
    train_step_split(torch, trainers["kernel"], *batches[0], marks, names)
    split = train_step_split(torch, trainers["kernel"], *batches[1], marks, names)
    print(f"renderer train step by stage, kernel path (CUDA events, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}, sum {sum(split.values()):.3f}",
          flush=True)
    busy = device_time_by_kernel(torch, lambda: trainers["kernel"].train_step(*batches[2]))
    print(f"renderer train step under torch.profiler, kernel path: {busy['wall_ms']:.3f} ms on the "
          f"host's clock, {busy['device_ms']:.3f} ms of kernels ({busy['device_ms'] / busy['wall_ms']:.1%} "
          f"busy) in {busy['launches']} launches; most device time: {json.dumps(busy['top'])}",
          flush=True)
    del trainers, models, model
    torch.cuda.empty_cache()
    return res


def device_time_by_kernel(torch, run, top: int = 8, ranges=()) -> dict:
    """``run()`` once under ``torch.profiler`` (CUDA activity): its time on
    the host's clock (synchronised), the device time of its kernels summed,
    their launch count and the ``top`` kernels by device time (ms). With
    ``ranges`` (names of ``record_function`` ranges) the host's ops are
    profiled too, and ``ranges`` maps each name to the device time of the
    kernels launched inside it, ``linked_ms`` is that of every kernel linked
    to a host op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    ms = {}
    for e in kernels:
        ms[e.key[:60]] = ms.get(e.key[:60], 0.0) + e.device_time_total / 1e3
    best = sorted(ms.items(), key=lambda kv: -kv[1])[:top]
    res = {"wall_ms": wall, "device_ms": sum(ms.values()), "launches": sum(e.count for e in kernels),
           "top": {k: round(v, 3) for k, v in best}}
    if ranges:
        host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        launched = lambda e: sum(k.duration for k in e.kernels) / 1e3  # noqa: E731

        def under(e) -> float:
            return launched(e) + sum(under(c) for c in e.cpu_children)

        res["ranges"] = {n: sum(under(e) for e in host if e.name == n) for n in ranges}
        res["linked_ms"] = sum(launched(e) for e in host)
    return res


def train_step_split(torch, tr, pts, lbl, marks, names) -> dict:
    """One training step of ``tr`` (``Trainer.train_step``'s work, step for
    step) split by CUDA events: one recorded by each hook of ``marks``
    ((module, "pre" or "post"), in the order the forward reaches them), then
    one after the loss, the backward and the optimizer each; ``names`` names
    the spans between consecutive events."""
    from pointvit_tpu_torch.train import cross_entropy_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(marks) + 3)]
    record = lambda i: lambda *_: ev[i].record()  # noqa: E731
    hooks = [(m.register_forward_pre_hook if when == "pre" else m.register_forward_hook)(record(i))
             for i, (m, when) in enumerate(marks)]
    try:
        tr.optimizer.zero_grad()
        logits = tr.model(pts, train=True, generator=tr.generator)
        loss = cross_entropy_loss(logits, lbl, tr.label_smoothing).mean()
        ev[-3].record()
        loss.backward()
        ev[-2].record()
        tr.optimizer.step()
        ev[-1].record()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def attention_bwd_phase(torch, label, qkv, heads, seed, iters=5, plain_iters=1) -> dict:
    """The attention backward kernel on ``qkv`` (a model's block-0 qkv) with
    a seeded bf16 cotangent: dq, dk and dv each within BF16_REL_TOL of its
    own max|ref| of the plain version, two runs bit-equal; then timed beside
    its bound (10 B S^2 E useful FLOPs) and SDPA's backward on the same
    inputs (timed only)."""
    from pointvit_tpu_torch.ops import attention_kernel

    B, S, E3 = qkv.shape
    E = E3 // 3
    g = torch.randn((B, S, E), generator=torch.Generator().manual_seed(seed)).to(qkv.device, torch.bfloat16)
    with torch.inference_mode():
        dk1 = attention_kernel.mha_qkv_bwd(qkv, g, heads)
        dk2 = attention_kernel.mha_qkv_bwd(qkv, g, heads)
        dp = attention_kernel.reference_mha_qkv_bwd(qkv, g, heads)
        torch.cuda.synchronize()
        if not torch.equal(dk1, dk2):
            fail(f"mha_qkv_bwd {label}: two runs on the same inputs are not bit-equal")
        if not torch.isfinite(dk1).all():
            fail(f"mha_qkv_bwd {label}: the gradient is not finite")
        d, r = rel_err(torch, dk1, dp)
        parts = [rel_err(torch, dk1[..., i * E:(i + 1) * E], dp[..., i * E:(i + 1) * E])[1]
                 for i in range(3)]
        print(f"mha_qkv_bwd {label} {tuple(qkv.shape)} heads {heads}: max|d| {d:.6g}; dq, dk, dv "
              f"each against its own max|ref| {', '.join(f'{p:.3g}' for p in parts)} (bound "
              f"{BF16_REL_TOL:.3g}); two runs bit-equal", flush=True)
        if not max(parts) <= BF16_REL_TOL:
            fail(f"mha_qkv_bwd {label} disagrees with its plain version")
        del dk2, dp
        res = dict(
            shape=f"{tuple(qkv.shape)}, {heads} heads", max_abs_err=d,
            ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv_bwd(qkv, g, heads), iters),
            plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv_bwd(qkv, g, heads),
                             plain_iters),
            # five S*S*D products per (batch, head): logits, dP, dV, dQ, dK
            **bound(10.0 * B * S * S * E, nbytes(qkv, g, dk1)))
    q, k, v = (t.clone().requires_grad_() for t in heads_of(qkv, heads))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = g.reshape(B, S, heads, -1).transpose(1, 2).contiguous()
    res["library_ms"] = cuda_ms(
        torch, lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True), iters)
    res["flops"] = 10.0 * B * S * S * E
    del q, k, v, out, go, dk1
    torch.cuda.empty_cache()
    return res


def record_gemms(module, run) -> list:
    """The GEMM calls that ``run`` makes through ``module.gemm`` (and
    through ``group_mlp_kernel.gemm``, which the encoder's and P3 stage's
    chains reach by ``gemm_group``): the first of each distinct product, as
    (a, w, bias, kwargs without pre_out, whether pre_out was given)."""
    from pointvit_tpu_torch.ops import group_mlp_kernel

    calls, seen, real = [], set(), module.gemm
    owners = (module, group_mlp_kernel)

    def rec(a, w, bias=None, **kw):
        pre = kw.pop("pre_out", None)
        res = kw.get("res")
        key = (tuple(a.shape), tuple(w.shape), bias is None, pre is None,
               None if res is None else res.dtype, *sorted((k, str(v)) for k, v in kw.items() if k != "res"))
        if key not in seen:
            seen.add(key)
            calls.append((a, w, bias, dict(kw), pre is not None))
        return real(a, w, bias, pre_out=pre, **kw)

    for owner in owners:
        owner.gemm = rec
    try:
        run()
    finally:
        for owner in owners:
            owner.gemm = real
    return calls


def record_calls(module, names, run) -> list:
    """The calls ``run`` makes of ``module``'s functions ``names``, in order,
    as (name, args, kwargs)."""
    calls, real = [], {n: getattr(module, n) for n in names}

    def recorder(name):
        def rec(*args, **kw):
            calls.append((name, args, kw))
            return real[name](*args, **kw)
        return rec

    for n in names:
        setattr(module, n, recorder(n))
    try:
        run()
    finally:
        for n in names:
            setattr(module, n, real[n])
    return calls


def group_mlp_ab(torch, label, module, x, w, flops) -> None:
    """The group-MLP kernels of ``module`` (the encoder's or the P3 stage's
    three launches) on (x, w): two runs bit-equal, timed in turns beside the
    GEMM chain they replace (``launch_chain``, with the shared group max),
    and each launch timed alone."""
    fused = module.fused_group_encoder if label == "group_encoder" else module.fused_p3_embed
    got, again = fused(x, w), fused(x, w)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{label}: two launches of the group-MLP kernels differ")
    plan = lambda: module.launch_plan(x, w)  # noqa: E731
    chain = lambda: module.launch_chain(x, w)  # noqa: E731
    tc1, tk1, tk2, tc2 = (cuda_ms(torch, f, 5) for f in (chain, plan, plan, chain))
    tk, tc = (tk1 + tk2) / 2, (tc1 + tc2) / 2
    parts = []
    for name, args, kw in record_calls(module, ("group_stack", "gemm", "group_head"), plan):
        fn = getattr(module, name)
        parts.append(f"{name} {cuda_ms(torch, lambda: fn(*args, **kw), 5):.4f} ms")
    print(f"{label} A/B: group-MLP kernels {tk:.4f} ms (runs {tk1:.4f}, {tk2:.4f}; {flops / tk / 1e9:.1f} "
          f"TFLOP/s), the GEMM chain (launch_chain) {tc:.4f} ms (runs {tc1:.4f}, {tc2:.4f}), ratio "
          f"{tk / tc:.3f}; two runs bit-equal; launch by launch: {', '.join(parts)}", flush=True)


def epilogue_of(kw: dict, has_pre: bool) -> str:
    """A recorded GEMM call's epilogue in words."""
    parts = [f"{kw['act']}"] if kw.get("act", "none") != "none" else []
    res = kw.get("res")
    if res is not None:
        parts.append(f"{str(res.dtype)[6:]} residual"
                     + (f" x{kw['res_scale']:g}" if kw.get("res_scale", 1.0) != 1.0 else "")
                     + (f" per {kw['res_div']} rows" if kw.get("res_div", 1) > 1 else ""))
    out = kw.get("out_dtype", "bfloat16")
    parts.append("no out" if out is None else f"{str(out).replace('torch.', '')} out")
    if has_pre:
        parts.append("bf16 pre")
    if kw.get("group"):
        parts.append(f"max per {kw['group']} rows")
    return ", ".join(parts)


def gemm_phase(torch, label, names, calls) -> list:
    """Each recorded product on its recorded inputs: the kernel against its
    plain version (bf16 outputs within GEMM_BF16_REL_TOL, f32 within
    GEMM_F32_REL_TOL of max|ref|; two runs bit-equal), timed beside its bound,
    the plain version and ``F.linear`` on the same bf16 operands (cuBLAS,
    timed only)."""
    from pointvit_tpu_torch.ops.gemm_kernel import gemm, gemm_instance, reference_gemm

    if len(names) != len(calls):
        fail(f"gemm {label}: {len(calls)} distinct products, expected {len(names)}")
    rows = []
    for name, (a, w, bias, kw, has_pre) in zip(names, calls):
        M, K = a.shape
        N = w.shape[0]
        pre = [torch.empty(M, N, dtype=torch.bfloat16, device=a.device) if has_pre else None
               for _ in range(3)]
        got = gemm(a, w, bias, pre_out=pre[0], **kw)
        again = gemm(a, w, bias, pre_out=pre[1], **kw)
        want = reference_gemm(a, w, bias, pre_out=pre[2], **kw)
        torch.cuda.synchronize()
        errs, max_abs = {}, 0.0
        for tag, g, g2, ref in (("out", got[0], again[0], want[0]), ("gmax", got[1], again[1], want[1]),
                                ("pre", pre[0], pre[1], pre[2])):
            if g is None:
                continue
            if not torch.equal(g, g2):
                fail(f"gemm {label} {name}: two runs of {tag} differ")
            tol = GEMM_F32_REL_TOL if g.dtype == torch.float32 else GEMM_BF16_REL_TOL
            d, r = rel_err(torch, g, ref)
            if not r <= tol:
                fail(f"gemm {label} {name}: {tag} {r:.3g} of max|ref| from its plain version (bound {tol:.3g})")
            errs[tag] = r
            max_abs = max(max_abs, d)
        # Each instance that can take the product (the ping-pong one and the
        # two-block 128-wide tile; the pick is one of them or the
        # persistent 128 x 256), held and timed beside the pick.
        picked = gemm_instance(M, N, K, act=kw.get("act", "none"), res=kw.get("res"),
                               group=kw.get("group", 0), pre_out=pre[0])
        others = {}
        for inst in ("pingpong", "128x128"):
            if inst == picked or (inst == "pingpong" and (N % 8 or kw.get("group"))) or N <= 64:
                continue
            outs = [gemm(a, w, bias, pre_out=pre[1], instance=inst, **kw) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(u is None or torch.equal(u, v) for u, v in zip(*outs)):
                fail(f"gemm {label} {name} {inst}: two runs differ")
            for tag, g, ref in (("out", outs[0][0], want[0]), ("gmax", outs[0][1], want[1]),
                                ("pre", pre[1], pre[2])):
                if g is None:
                    continue
                tol = GEMM_F32_REL_TOL if g.dtype == torch.float32 else GEMM_BF16_REL_TOL
                if not rel_err(torch, g, ref)[1] <= tol:
                    fail(f"gemm {label} {name} {inst}: {tag} disagrees with the plain version")
            others[inst] = cuda_ms(torch, lambda: gemm(a, w, bias, pre_out=pre[1], instance=inst, **kw), 10)
            del outs
        del again, want
        flops = 2.0 * M * N * K
        moved = nbytes(*(t for t in (a, w, bias, kw.get("res"), got[0], got[1], pre[0]) if t is not None))
        ms = cuda_ms(torch, lambda: gemm(a, w, bias, pre_out=pre[0], **kw), 10)
        row = dict(name=name, shape=f"({M}, {K}) -> {N}", ms=ms, tflops=flops / ms / 1e9,
                   plain_ms=cuda_ms(torch, lambda: reference_gemm(a, w, bias, pre_out=pre[2], **kw), 2),
                   library_ms=cuda_ms(torch, lambda: torch.nn.functional.linear(a, w, bias), 10),
                   errs=errs, max_abs_err=max_abs, instance=picked, others=others, **bound(flops, moved))
        epi = epilogue_of(kw, has_pre)
        alt = "".join(f", {k} {v:.4f} ms" for k, v in others.items())
        print(f"time gemm {label} {name} {row['shape']} [{epi}]: kernel ({picked}) {ms:.4f} ms, "
              f"{row['tflops']:.1f} TFLOP/s, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"plain {row['plain_ms']:.4f} ms, F.linear (cuBLAS) {row['library_ms']:.4f} ms{alt}; "
              f"max|d| / max|ref| {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; "
              f"repeats bit-equal", flush=True)
        rows.append(row)
        del got, pre
    return rows


def heads_of(t, h):
    """q, k, v (B, H, S, D) of a packed (B, S, 3E) qkv, for SDPA."""
    b, n, e3 = t.shape
    return [u.contiguous() for u in t.reshape(b, n, 3, h, e3 // 3 // h).permute(2, 0, 3, 1, 4)]


def pix4point_stages(torch, model, pts) -> dict:
    """One forward of the served Pix4Point model, split by CUDA events that
    hooks on its own submodules record: tokenizer (FPS + kNN: entering
    ``patch_embed`` to entering its P3 stage), P3 stage (to leaving
    ``patch_embed``), blocks (proj, pos MLP, cls and the blocks: to leaving
    the last block), head (final norm, pooling, ``cls_head``)."""
    from pointvit_tpu_torch.nn import pointnet

    vit = model.model
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    record = lambda i: lambda *_: ev[i].record()  # noqa: E731
    stage, entered = pointnet.fused_p3_embed, []

    def timed_stage(*args):  # the stage P3Embed's own gate chose
        entered.append(1)
        ev[1].record()
        return stage(*args)

    hooks = [vit.patch_embed.register_forward_pre_hook(record(0)),
             vit.patch_embed.register_forward_hook(record(2)),
             vit.blocks[-1].register_forward_hook(record(3)),
             model.cls_head.register_forward_hook(record(4))]
    pointnet.fused_p3_embed = timed_stage
    try:
        with torch.inference_mode():
            model(pts)
    finally:
        pointnet.fused_p3_embed = stage
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    if entered != [1]:
        fail("the served P3Embed did not take its fused stage")
    names = ("tokenizer", "p3_stage", "blocks", "head")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def pix4point_phase(torch, dev, _build) -> dict:
    """Pix4Point serving at full width and depth, kernel path against the
    plain path; returns the launch counts, the kernel-path model and one
    bucket-256 request."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    model = build_model(P4P_CONFIG)
    randomize(torch, model, torch.Generator().manual_seed(SEED + 3))
    plain = build_model(P4P_CONFIG, implementation="torch")
    plain.load_state_dict(model.state_dict())
    sess = InferenceSession(model, device=dev)
    psess = InferenceSession(plain, device=dev)
    rng = np.random.default_rng(SEED + 3)
    requests = [rng.standard_normal((n, P4P_POINTS, 3)).astype(np.float32) for n in REQUESTS]
    sess.warmup(requests[0][0])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    served = [sess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"pix4point launches during serving: {json.dumps(counts)}", flush=True)
    want = [psess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    got_all, want_all = np.concatenate(served), np.concatenate(want)
    classes = P4P_CONFIG["num_classes"]
    if got_all.shape != (sum(REQUESTS), classes) or not np.isfinite(got_all).all():
        fail(f"pix4point logits: shape {got_all.shape}, finite {np.isfinite(got_all).all()}")
    agree = float((got_all.argmax(-1) == want_all.argmax(-1)).mean())
    dlogit = float(np.abs(got_all - want_all).max())
    scale = float(np.abs(want_all).max())
    print(f"pix4point serving: requests {list(REQUESTS)} of {P4P_POINTS} points: argmax agreement "
          f"{agree:.4f} (need >= {ARGMAX_AGREEMENT}), max|dlogit| {dlogit:.6g} vs max|logit| "
          f"{scale:.6g} (bound {LOGIT_REL_TOL} x max|logit|)", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail("pix4point kernel-path logits disagree with the plain path")
    for name in P4P_COUNTERS:
        if counts.get(name, 0) <= 0:
            fail(f"the pix4point serving path never launched the {name} kernel")
    if counts.get("p3_embed_chain", 0):
        fail("the bf16 pix4point serving path ran the P3 stage's GEMM chain, not its group-MLP kernels")

    big = requests[-1]
    tp1 = cuda_ms(torch, lambda: psess.predict_logits(big), 2)
    tk1 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    tk2 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    tp2 = cuda_ms(torch, lambda: psess.predict_logits(big), 2)
    tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    print(f"pix4point serving throughput at bucket 256: kernel path {256e3 / tk:.1f} clouds/s "
          f"({tk:.3f} ms/request; runs {tk1:.3f}, {tk2:.3f}), plain path {256e3 / tp:.1f} "
          f"clouds/s ({tp:.3f} ms/request; runs {tp1:.3f}, {tp2:.3f})", flush=True)
    pts = torch.from_numpy(big).to(dev)
    pix4point_stages(torch, model, pts)  # warm-up of the split forward
    stages = pix4point_stages(torch, model, pts)
    print(f"pix4point forward at bucket 256 by stage (CUDA events, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}, sum "
          f"{sum(stages.values()):.3f}", flush=True)
    del psess, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "model": model, "points": pts}


def unit_sphere(pts: np.ndarray) -> np.ndarray:
    """Clouds centred and scaled into the unit sphere, as the dataset's
    ``normalize: True``, so that every view holds the cloud."""
    pts = pts - pts.mean(axis=1, keepdims=True)
    return (pts / np.linalg.norm(pts, axis=-1).max(axis=1)[:, None, None]).astype(np.float32)


def renderer_stages(torch, model, pts) -> tuple[dict, object]:
    """One forward of the served renderer, split by CUDA events that hooks on
    its own submodules record: view network (``view_transform_net``), render
    (to entering ``vit.conv_proj``: the splat and the cast to bf16 RGB),
    patchify + pos (to entering block 0), the blocks (to leaving the last),
    head (final LN of the cls rows, view aggregation, ``classifier``).
    Returns the stage times and block 0's input."""
    vit = model.vit
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    record = lambda i: lambda *_: ev[i].record()  # noqa: E731
    x0 = []

    def block0_entered(_, args):
        ev[3].record()
        x0.append(args[0])

    hooks = [model.view_transform_net.register_forward_pre_hook(record(0)),
             model.view_transform_net.register_forward_hook(record(1)),
             vit.conv_proj.register_forward_pre_hook(record(2)),
             vit.encoder_layer[0].register_forward_pre_hook(block0_entered),
             vit.encoder_layer[-1].register_forward_hook(record(4)),
             model.classifier.register_forward_hook(record(5))]
    try:
        with torch.inference_mode():
            model(pts)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    names = ("view_net", "render", "patchify_pos", "blocks", "head")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}, x0[0]


def renderer_phase(torch, dev, _build) -> dict:
    """Renderer serving at full width and depth, kernel path against the
    plain path; returns the launch counts, the kernel-path model and block
    0's input at bucket 256."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    torch.cuda.reset_peak_memory_stats()
    model = build_model(RENDERER_CONFIG)
    randomize(torch, model, torch.Generator().manual_seed(SEED + 4))
    zero = [n for n, p in model.named_parameters() if not p.detach().any()]
    if zero:  # adapters' up projections, cls token, VTN heads start at zero
        fail(f"renderer parameters left at zero by randomize: {zero[:5]}")
    plain = build_model(RENDERER_CONFIG, implementation="torch")
    plain.load_state_dict(model.state_dict())
    sess = InferenceSession(model, device=dev)
    psess = InferenceSession(plain, device=dev)
    rng = np.random.default_rng(SEED + 4)
    requests = [unit_sphere(rng.standard_normal((n, RENDERER_POINTS, 3))) for n in REQUESTS]
    sess.warmup(requests[0][0])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    served = [sess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"renderer launches during serving: {json.dumps(counts)}", flush=True)
    want = [psess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    got_all, want_all = np.concatenate(served), np.concatenate(want)
    classes = RENDERER_CONFIG["num_classes"]
    if got_all.shape != (sum(REQUESTS), classes) or not np.isfinite(got_all).all():
        fail(f"renderer logits: shape {got_all.shape}, finite {np.isfinite(got_all).all()}")
    agree = float((got_all.argmax(-1) == want_all.argmax(-1)).mean())
    dlogit = float(np.abs(got_all - want_all).max())
    scale = float(np.abs(want_all).max())
    print(f"renderer serving: requests {list(REQUESTS)} of {RENDERER_POINTS} points: argmax "
          f"agreement {agree:.4f} (need >= {ARGMAX_AGREEMENT}), max|dlogit| {dlogit:.6g} vs "
          f"max|logit| {scale:.6g} (bound {LOGIT_REL_TOL} x max|logit|)", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail("renderer kernel-path logits disagree with the plain path")
    for name in RENDERER_COUNTERS:
        if counts.get(name, 0) <= 0:
            fail(f"the renderer serving path never launched the {name} kernel")

    big = requests[-1]
    tp1 = cuda_ms(torch, lambda: psess.predict_logits(big), 1)
    tk1 = cuda_ms(torch, lambda: sess.predict_logits(big), 3)
    tk2 = cuda_ms(torch, lambda: sess.predict_logits(big), 3)
    tp2 = cuda_ms(torch, lambda: psess.predict_logits(big), 1)
    tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    print(f"renderer serving throughput at bucket 256 (kernel path 2 x 3 timed requests, plain "
          f"path 2 x 1): kernel path {256e3 / tk:.1f} clouds/s ({tk:.3f} ms/request; runs "
          f"{tk1:.3f}, {tk2:.3f}), plain path {256e3 / tp:.1f} clouds/s ({tp:.3f} ms/request; "
          f"runs {tp1:.3f}, {tp2:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del psess, plain
    torch.cuda.empty_cache()
    pts = torch.from_numpy(big).to(dev)
    renderer_stages(torch, model, pts)  # warm-up of the split forward
    stages, x0 = renderer_stages(torch, model, pts)
    print(f"renderer forward at bucket 256 by stage (CUDA events, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}, sum "
          f"{sum(stages.values()):.3f}", flush=True)
    return {"counts": counts, "model": model, "x0": x0}


def apf_stages(torch, model, pts) -> dict:
    """One forward of a served APF model, split by CUDA events that hooks on
    the model and its own submodules record: tokenizer (FPS, Morton order,
    kNN: to entering ``point_encoder``), encoder, blocks (to leaving the
    last), head (final norm, pooling, head)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    record = lambda i: lambda *_: ev[i].record()  # noqa: E731
    hooks = [model.register_forward_pre_hook(record(0)),
             model.point_encoder.register_forward_pre_hook(record(1)),
             model.point_encoder.register_forward_hook(record(2)),
             model.blocks[-1].register_forward_hook(record(3)),
             model.register_forward_hook(record(4))]
    try:
        with torch.inference_mode():
            model(pts)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    names = ("tokenizer", "encoder", "blocks", "head")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def quant_phase(torch, dev, _build, base, requests, base_logits, base_ms) -> dict:
    """Quantized APF slim2 serving on ``base``'s weights (the bf16 serving
    model), kernel path against the plain path; returns the launch counts,
    the kernel-path model and the inputs its int8 layers got in one
    bucket-256 forward."""
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config
    from pointvit_tpu_torch.serve import InferenceSession

    cfg = apf_preset_config("slim2", quantized=True)
    model = AdaptPointFormer(**cfg)
    plain = AdaptPointFormer(**cfg, implementation="torch")
    model.load_state_dict(base.state_dict())
    plain.load_state_dict(base.state_dict())
    sess = InferenceSession(model, device=dev)
    psess = InferenceSession(plain, device=dev)
    sess.warmup(requests[0][0])  # also quantizes the weights, once
    psess.warmup(requests[0][0])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    served = [sess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"quantized launches during serving: {json.dumps(counts)}", flush=True)
    want = [psess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    got_all, want_all = np.concatenate(served), np.concatenate(want)
    if got_all.shape != (sum(REQUESTS), cfg["num_classes"]) or not np.isfinite(got_all).all():
        fail(f"quantized logits: shape {got_all.shape}, finite {np.isfinite(got_all).all()}")
    same, gap, decided = untied(got_all, want_all)
    dlogit = float(np.abs(got_all - want_all).max())
    scale = float(np.abs(want_all).max())
    agree = float(same[decided].mean())
    print(f"quantized serving: requests {list(REQUESTS)}: argmax agreement {same.mean():.4f} over "
          f"all {same.size} clouds (top-2 plain-path gaps of the {int((~same).sum())} that differ: "
          f"{[float(g) for g in gap[~same]]}), {agree:.4f} over the {int(decided.sum())} whose gap "
          f"exceeds {BF16_REL_TOL * scale:.4g} (need >= {ARGMAX_AGREEMENT}); max|dlogit| "
          f"{dlogit:.6g} vs max|logit| {scale:.6g} (bound {LOGIT_REL_TOL} x max|logit|)", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail("quantized kernel-path logits disagree with the plain path")
    for name in QUANT_COUNTERS:
        if counts.get(name, 0) <= 0:
            fail(f"the quantized serving path never launched the {name} kernel")
    for name in QUANT_UNUSED:
        if counts.get(name, 0):
            fail(f"the quantized serving path launched the {name} kernel")
    bf_agree = float((got_all.argmax(-1) == base_logits.argmax(-1)).mean())
    bf_d = float(np.abs(got_all - base_logits).max())
    print(f"quantized vs the bf16 kernel path (no bound): argmax agreement {bf_agree:.4f}, "
          f"max|dlogit| {bf_d:.6g} vs max|logit| {float(np.abs(base_logits).max()):.6g}", flush=True)

    big = requests[-1]
    tp1 = cuda_ms(torch, lambda: psess.predict_logits(big), 2)
    tk1 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    tk2 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    tp2 = cuda_ms(torch, lambda: psess.predict_logits(big), 2)
    tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    print(f"quantized serving throughput at bucket 256: kernel path {256e3 / tk:.1f} clouds/s "
          f"({tk:.3f} ms/request; runs {tk1:.3f}, {tk2:.3f}), plain path {256e3 / tp:.1f} "
          f"clouds/s ({tp:.3f} ms/request; runs {tp1:.3f}, {tp2:.3f}); the bf16 kernel path "
          f"{256e3 / base_ms:.1f} clouds/s ({base_ms:.3f} ms/request)", flush=True)
    del psess, plain
    torch.cuda.empty_cache()
    pts = torch.from_numpy(big).to(dev)
    apf_stages(torch, model, pts)  # warm-up of the split forward
    stages = apf_stages(torch, model, pts)
    print(f"quantized forward at bucket 256 by stage (CUDA events, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}, sum "
          f"{sum(stages.values()):.3f}", flush=True)

    layers = dict(model.named_modules())
    inputs = {}
    hooks = [layers[n].register_forward_pre_hook(lambda _, a, n=n: inputs.__setitem__(n, a[0]))
             for n in QUANT_LAYERS]
    try:
        with torch.inference_mode():
            model(pts)
    finally:
        for h in hooks:
            h.remove()
    return {"counts": counts, "model": model, "inputs": inputs}


def knn_wide_phase(torch, _build, pts) -> dict:
    """The grouping op (``ops.group.p3_group``, Pix4Point's first stage) with
    KNN_WIDE_K neighbours, above the kNN list instance's 64: the kernel path
    launches the rows instance and agrees bit for bit with the plain path.
    Returns the launch counts of the kernel path's call."""
    from pointvit_tpu_torch.ops.group import p3_group

    feats = torch.cat([pts, pts], -1).contiguous()
    _build.reset_launch_counts()
    got = p3_group(pts, feats, P4P_TOKENS, KNN_WIDE_K)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = p3_group(pts, feats, P4P_TOKENS, KNN_WIDE_K, implementation="torch")
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"p3_group with k {KNN_WIDE_K}: the kernel path differs from the plain path")
    if counts.get("knn_rows", 0) <= 0 or counts.get("knn", 0) != 0:
        fail(f"p3_group with k {KNN_WIDE_K} did not take the kNN rows instance alone: {counts}")
    print(f"p3_group with k {KNN_WIDE_K} {tuple(pts.shape)}: the rows instance, bit-equal to the plain path; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    return counts


def attn_block_phase(torch, dev, _build, cases) -> tuple[dict, dict]:
    """``fused_attention_block`` forward and backward at each case's shape,
    on block 0's LayerNorm output and attention weights: the kernel path
    (counted) against the plain path and an f32 run of the same step.
    Returns the launch counts and the timings per case."""
    from pointvit_tpu_torch.ops.attention_kernel import (
        attn_block, fused_attention_block, reference_attn_block,
    )

    prepared = []
    for i, (label, x, w, heads) in enumerate(cases):
        x = x.clone()  # a normal tensor: autograd saves it
        w = [t.detach().float().clone() for t in w]
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + 10 + i))
        prepared.append((label, x, w, heads, g.to(dev, torch.bfloat16)))

    def step(x, w, heads, g, impl, dtype):
        args = [x.to(dtype, copy=True).requires_grad_()] + [t.clone().requires_grad_() for t in w]
        out = fused_attention_block(*args, heads, implementation=impl)
        out.backward(g.to(dtype))
        return out.detach(), [a.grad for a in args]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    kernel_runs = [step(x, w, h, g, None, torch.bfloat16) for _, x, w, h, g in prepared]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"attn_block launches during its forward and backward at {len(cases)} shapes: "
          f"{json.dumps(counts)}", flush=True)
    for name in ("attn_block", "mha_qkv_bwd", "gemm"):
        if counts.get(name, 0) <= 0:
            fail(f"fused_attention_block never launched the {name} kernel")

    names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj")
    timings = {}
    for (label, x, w, heads, g), (out, gk) in zip(prepared, kernel_runs):
        B, S, E = x.shape
        with torch.no_grad():
            want = reference_attn_block(x, *w, heads)
        d, r = rel_err(torch, out, want)
        print(f"attn_block {label} {tuple(x.shape)} heads {heads}: forward max|d| {d:.6g}, relative "
              f"to max|ref| {r:.3g} (bound {BF16_REL_TOL:.3g})", flush=True)
        if not r <= BF16_REL_TOL:
            fail(f"attn_block {label}: the forward disagrees with reference_attn_block")
        _, gp = step(x, w, heads, g, "torch", torch.bfloat16)
        _, gf = step(x, w, heads, g, "torch", torch.float32)
        worst = []
        for n, a, p, f in zip(names, gk, gp, gf):
            kp, kf, pf = rel_l2(a, p), rel_l2(a, f), rel_l2(p, f)
            worst.append(f"{n} {kp:.3g} / {kf:.3g} vs {pf:.3g}")
            if not (kp <= TRAIN_GRAD_REL_TOL and kf <= TRAIN_GRAD_F32_RATIO * pf):
                fail(f"attn_block {label}: the {n} gradient disagrees with the plain path's or f32's")
        print(f"attn_block {label} backward, relative L2 kernel vs plain / kernel vs f32 vs plain "
              f"vs f32 (bounds {TRAIN_GRAD_REL_TOL}; {TRAIN_GRAD_F32_RATIO}x): {'; '.join(worst)}",
              flush=True)
        del gp, gf

        w16 = [t.to(torch.bfloat16) for t in w]
        mha = torch.nn.MultiheadAttention(E, heads, batch_first=True, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            mha.in_proj_weight.copy_(w16[0].t())
            mha.in_proj_bias.copy_(w16[1])
            mha.out_proj.weight.copy_(w16[2].t())
            mha.out_proj.bias.copy_(w16[3])
        mha.eval()
        flops = 8.0 * B * S * E * E + 4.0 * B * S * S * E
        with torch.inference_mode():
            lib_d = rel_err(torch, mha(x, x, x, need_weights=False)[0], want)[1]
            res = dict(
                shape=f"{tuple(x.shape)}, {heads} heads", max_abs_err=d,
                ms=cuda_ms(torch, lambda: attn_block(x, *w16, heads), 5),
                plain_ms=cuda_ms(torch, lambda: reference_attn_block(x, *w16, heads), 2),
                **bound(flops, 2 * nbytes(x) + sum(2 * t.numel() for t in w16)),
                library_ms=cuda_ms(torch, lambda: mha(x, x, x, need_weights=False), 5),
                flops=flops)
        res["train_ms"] = cuda_ms(torch, lambda: step(x, w, heads, g, None, torch.bfloat16), 2)
        res["train_plain_ms"] = cuda_ms(torch, lambda: step(x, w, heads, g, "torch", torch.bfloat16), 1)
        print(f"attn_block {label}: torch.nn.MultiheadAttention (timed only) against "
              f"reference_attn_block: max|d| / max|ref| {lib_d:.3g}", flush=True)
        timings[label] = res
        del mha
    del kernel_runs, prepared
    torch.cuda.empty_cache()
    return counts, timings


# The serving_io phase: slim2 as the reference-style config dict a checkpoint's
# sidecar carries (build_model rebuilds apf_preset_config("slim2") from it),
# the clouds the HTTP clients send, and each family's artifact at depth 2
# (full width) with the counters (rows 7 and 8, 9, 10) its serving must raise.
SLIM2_MODEL_CONFIG = {"num_classes": 40, "in_channels": 3, "embedding_dim": 768, "npoint": 196,
                      "nsample": 16, "depth": 12, "num_heads": 12, "encoder_second_width": 384, "bf16": True}
HTTP_CLIENTS, HTTP_BATCH = 64, 256
IO_ARTIFACT_BATCH = 8
IO_FAMILIES = (
    ("Pix4Point vit_small", {**P4P_CONFIG, "depth": 2}, P4P_POINTS, ("p3_embed", "vit_block")),
    ("renderer vit_b_16", {**RENDERER_CONFIG, "depth": 2}, RENDERER_POINTS, ("serial_block",)),
    ("quantized APF slim2", {**SLIM2_MODEL_CONFIG, "depth": 2, "quantized": True}, POINTS, ("quant_dense",)),
)


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def serving_gate(label: str, got: np.ndarray, want: np.ndarray) -> None:
    """PERF.md §2's serving gate: argmax equal on >= 99 % of the clouds
    whose top-2 gap exceeds BF16_REL_TOL x max|logit| (ties aside), max
    |dlogit| within LOGIT_REL_TOL x max|logit|; finite logits of one shape."""
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label}: logits of shape {got.shape} (want {want.shape}), finite {np.isfinite(got).all()}")
    same, _, decided = untied(got, want)
    agree = float(same[decided].mean()) if decided.any() else 1.0
    dlogit, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    print(f"{label}: {len(got)} clouds, argmax agreement {agree:.4f} over the {int(decided.sum())} untied "
          f"(need >= {ARGMAX_AGREEMENT}), max|dlogit| {dlogit:.6g} vs max|logit| {scale:.6g} (bound "
          f"{LOGIT_REL_TOL} x max|logit|), bit-equal {np.array_equal(got, want)}", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail(f"{label}: logits outside the serving gate")


def checkpoint_phase(torch, dev, model, requests, tmp) -> object:
    """(a) slim2 as a JAX-format checkpoint (params, batch_stats, the
    opt_state of APF's masked AdamW in the JAX trainer's optax layout,
    ``adamw_to_optax``, EMA trees = the weights plus seeded noise, a sidecar)
    and as a port .pt checkpoint with an "ema" dict, each served by
    InferenceSession.from_checkpoint bit-equal to a session over a model
    loaded from the same trees, EMA by default and raw with use_ema=False.
    Returns the JAX checkpoint's session (EMA)."""
    import os

    from pointvit_tpu_torch.convert import adamw_to_optax, load_flax_variables, state_dict_to_flax
    from pointvit_tpu_torch.models import apf_trainable_mask, build_model
    from pointvit_tpu_torch.serve import InferenceSession
    from pointvit_tpu_torch.train import build_optimizer, constant_schedule
    from pointvit_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + 40)
    noisy = lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape, dtype=np.float32))).astype(np.float32)  # noqa: E731
    tree = state_dict_to_flax(model)
    ema = {"params": tree_map(noisy, tree["params"]), "batch_stats": tree_map(noisy, tree["batch_stats"])}
    # the optimizer state in the layout a JAX APF trainer writes (masked
    # AdamW: moments for the trainable tensors, MaskedNode for the frozen)
    copy = build_model(SLIM2_MODEL_CONFIG)
    copy.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = build_optimizer(copy, constant_schedule(LR), weight_decay=WEIGHT_DECAY,
                          trainable_mask=apf_trainable_mask(copy))
    opt.count = 7
    opt_state = adamw_to_optax(copy, opt)
    del copy, opt
    state = {"params": tree["params"], "batch_stats": tree["batch_stats"], "opt_state": opt_state, "step": 7,
             "ema_params": ema["params"], "ema_batch_stats": ema["batch_stats"]}
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    trained = apf_trainable_mask(model) | {k for k in sd if k.endswith(("running_mean", "running_var"))}
    pt_ema = {k: torch.from_numpy(noisy(sd[k].float().numpy())) for k in sorted(trained)}
    files = {}
    for fmt, name, payload in (("msgpack", "model_best.msgpack", state),
                               ("pt", "model_best.pt", {"model": sd, "optimizer": {}, "step": 7, "ema": pt_ema})):
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, name, epoch=3, accuracy=0.5, state=payload, model_config=SLIM2_MODEL_CONFIG,
                               dataset_config={"name": "synthetic"})
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = {use_ema: InferenceSession.from_checkpoint(path, use_ema=use_ema, device=dev)
                  for use_ema in (True, False)}
        torch.cuda.synchronize()
        t_read = (time.perf_counter() - t0) / 2
        files[fmt] = (path, served)
        print(f"checkpoint {fmt}: {os.path.getsize(path) / 2**20:.1f} MiB written in {t_write:.2f} s, read and "
              f"served (parse, build_model, load, to the card) in {t_read:.2f} s", flush=True)

    def session(load):
        m = build_model(SLIM2_MODEL_CONFIG)
        load(m)
        return InferenceSession(m, device=dev)

    raw = session(lambda m: load_flax_variables(m, tree))  # the model's own weights: both formats' raw trees
    refs = {("msgpack", True): session(lambda m: load_flax_variables(m, ema)), ("msgpack", False): raw,
            ("pt", True): session(lambda m: m.load_state_dict({**sd, **pt_ema})), ("pt", False): raw}
    for (fmt, use_ema), ref in refs.items():
        for r in (requests[0], requests[2], requests[3]):
            got, want = files[fmt][1][use_ema].predict_logits(r), ref.predict_logits(r)
            if not np.array_equal(got, want):
                fail(f"the {fmt} checkpoint served with use_ema={use_ema} differs from its trees' session at "
                     f"{len(r)} clouds: max|d| {np.abs(got - want).max():.6g}")
        print(f"checkpoint {fmt}, use_ema={use_ema}: requests {len(requests[0])}, {len(requests[2])}, "
              f"{len(requests[3])} bit-equal to the session over a model "
              f"loaded from the {'EMA' if use_ema else 'raw'} trees", flush=True)
    raw_vs_ema = np.abs(files["msgpack"][1][True].predict_logits(requests[2]) - raw.predict_logits(requests[2])).max()
    if raw_vs_ema == 0:
        fail("the EMA weights served the raw weights' logits")
    return files["msgpack"][1][True]


def export_phase(torch, dev, _build, sess, requests, served, tmp) -> list:
    """(b) slim2 exported on the card (torch.export over the kernels' custom
    ops), saved, served by InferenceSession.from_exported: requests 1, 5,
    32, 256 within the serving gate of the live session's, every serving
    counter raised and the encoder's GEMM chain not; bucket 256 timed
    against the live session. Then Pix4Point, the renderer and quantized APF
    at depth 2 and full width, each against its live model. Returns the
    launch counts of the artifacts' serving."""
    import os

    from pointvit_tpu_torch.export import export_forward, load_forward, save_exported
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    t0 = time.perf_counter()
    blob = export_forward(sess.model, requests[0])
    t_export = time.perf_counter() - t0
    path = os.path.join(tmp, "slim2.pt2")
    save_exported(path, blob)
    t0 = time.perf_counter()
    art = InferenceSession.from_exported(path)
    t_load = time.perf_counter() - t0
    print(f"export slim2: {t_export:.2f} s to trace and serialise, {len(blob)} bytes, {t_load:.2f} s to load "
          f"(one batch-polymorphic program for the buckets {list(art.buckets)})", flush=True)
    art.warmup(requests[0][0])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = [art.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    counts = [_build.launch_counts()]
    print(f"launches while serving the slim2 artifact: {json.dumps(counts[0])}", flush=True)
    for name in SERVING_COUNTERS:
        if counts[0].get(name, 0) <= 0:
            fail(f"the slim2 artifact never launched the {name} kernel")
    if counts[0].get("group_encoder_chain", 0):
        fail("the slim2 artifact ran the encoder's GEMM chain, not its group-MLP kernels")
    for r, g, w in zip(requests, got, served):
        serving_gate(f"slim2 artifact vs the live session, request of {len(r)}", g, w)
    big = requests[-1]
    ta1 = cuda_ms(torch, lambda: art.predict_logits(big), 5)
    tl1 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    tl2 = cuda_ms(torch, lambda: sess.predict_logits(big), 5)
    ta2 = cuda_ms(torch, lambda: art.predict_logits(big), 5)
    print(f"bucket-256 request: artifact {(ta1 + ta2) / 2:.3f} ms (runs {ta1:.3f}, {ta2:.3f}), live session "
          f"{(tl1 + tl2) / 2:.3f} ms (runs {tl1:.3f}, {tl2:.3f})", flush=True)
    del art, blob

    rng = np.random.default_rng(SEED + 41)
    for i, (label, cfg, points, rows) in enumerate(IO_FAMILIES):
        model = build_model(cfg)
        randomize(torch, model, torch.Generator().manual_seed(SEED + 42 + i))
        live = InferenceSession(model, buckets=(IO_ARTIFACT_BATCH,), device=dev)
        clouds = rng.standard_normal((IO_ARTIFACT_BATCH, points, 3)).astype(np.float32)
        if cfg.get("num_views"):
            clouds = unit_sphere(clouds)
        want = live.predict_logits(clouds)
        t0 = time.perf_counter()
        fn = load_forward(export_forward(model, clouds))
        t_export = time.perf_counter() - t0
        _build.reset_launch_counts()
        got = fn(clouds).cpu().numpy()
        torch.cuda.synchronize()
        counts.append(_build.launch_counts())
        print(f"export {label} (depth 2): {t_export:.2f} s; launches while serving it: "
              f"{json.dumps({k: v for k, v in counts[-1].items() if v})}", flush=True)
        for name in rows:
            if counts[-1].get(name, 0) <= 0:
                fail(f"the {label} artifact never launched the {name} kernel")
        serving_gate(f"{label} artifact vs its live model", got, want)
        del model, live, fn
    torch.cuda.empty_cache()
    return counts


def http_phase(torch, _build, sess, requests) -> dict:
    """(c) make_server(port=0) over ``sess`` on 127.0.0.1: 64 threads each
    POST one cloud to /v1/classify (.npy both ways), one /v1/classify_batch
    of 256 clouds as JSON and one as .npy; every logit within the serving
    gate of predict_logits on the same clouds; /v1/health 200, a bad channel
    count 400, an oversized body 413. Returns the launch counts."""
    import http.client
    import io
    import threading
    import urllib.error
    import urllib.request

    from pointvit_tpu_torch.serve_http import make_server

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    def post(path, body, ctype, accept="application/x-npy"):
        req = urllib.request.Request(base + path, data=body, method="POST",
                                     headers={"Content-Type": ctype, "Accept": accept})
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read()
            return np.load(io.BytesIO(raw)) if accept == "application/x-npy" else json.loads(raw)

    clouds = requests[-1]
    want = sess.predict_logits(clouds)
    srv = make_server(sess, host="127.0.0.1", port=0, max_batch=HTTP_CLIENTS, max_delay_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/v1/health", timeout=60) as resp:
            health = json.loads(resp.read())
            if resp.status != 200 or health["status"] != "ok":
                fail(f"/v1/health: {resp.status} {health}")
        print(f"http /v1/health: {health}", flush=True)
        post("/v1/classify", npy(clouds[0]), "application/x-npy")  # warm the connection path
        _build.reset_launch_counts()
        results, errors = [None] * HTTP_CLIENTS, []

        def client(i):
            try:
                results[i] = post("/v1/classify", npy(clouds[i]), "application/x-npy")
            except Exception as e:  # reported below: the phase fails on it
                errors.append(f"client {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        flushes = []  # the clouds of each batcher flush: how the clients coalesced
        predict = sess.predict_logits
        sess.predict_logits = lambda points: flushes.append(len(points)) or predict(points)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_clients = time.perf_counter() - t0
        del sess.predict_logits
        if errors:
            fail(f"http /v1/classify: {errors[:3]}")
        print(f"http: the {HTTP_CLIENTS} clients' clouds reached the session in {len(flushes)} flushes of "
              f"{flushes} clouds", flush=True)
        serving_gate(f"http /v1/classify, {HTTP_CLIENTS} concurrent clients", np.stack(results),
                     want[:HTTP_CLIENTS])
        t0 = time.perf_counter()
        as_json = post("/v1/classify_batch", json.dumps({"points": clouds.tolist()}).encode(), "application/json",
                       accept="application/json")
        t_json = time.perf_counter() - t0
        t0 = time.perf_counter()
        as_npy = post("/v1/classify_batch", npy(clouds), "application/x-npy")
        t_npy = time.perf_counter() - t0
        counts = _build.launch_counts()
        serving_gate(f"http /v1/classify_batch of {HTTP_BATCH}, JSON", np.asarray(as_json["logits"], np.float32),
                     want)
        serving_gate(f"http /v1/classify_batch of {HTTP_BATCH}, .npy", as_npy, want)
        print(f"http throughput: {HTTP_CLIENTS} concurrent /v1/classify clients {HTTP_CLIENTS / t_clients:.1f} "
              f"clouds/s ({t_clients:.3f} s); /v1/classify_batch of {HTTP_BATCH} as .npy "
              f"{HTTP_BATCH / t_npy:.1f} clouds/s ({t_npy:.3f} s), as JSON {HTTP_BATCH / t_json:.1f} clouds/s "
              f"({t_json:.3f} s)", flush=True)
        try:
            post("/v1/classify", npy(np.zeros((POINTS, 4), np.float32)), "application/x-npy")
            fail("http: a cloud of 4 channels was not refused")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                fail(f"http: a cloud of 4 channels got {e.code}, not 400")
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            conn.putrequest("POST", "/v1/classify")
            conn.putheader("Content-Type", "application/x-npy")
            conn.putheader("Content-Length", str(10**12))
            conn.endheaders()
            status = conn.getresponse().status
        finally:
            conn.close()
        if status != 413:
            fail(f"http: an oversized body got {status}, not 413")
        print("http: /v1/health 200, a cloud of 4 channels 400, an oversized body 413", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    return counts


def serving_io_phase(torch, dev, _build, model, sess, requests, served) -> list:
    """Checkpoints, export and the HTTP front door at full width and depth
    (APF slim2); returns the launch counts of the phase's serving."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = checkpoint_phase(torch, dev, model, requests, tmp)
        t_ck = time.perf_counter() - t0
        counts = export_phase(torch, dev, _build, sess, requests, served, tmp)
        t_ex = time.perf_counter() - t0 - t_ck
        counts.append(http_phase(torch, _build, ck, requests))
    del ck
    torch.cuda.empty_cache()
    print(f"serving_io phase: {time.perf_counter() - t0:.1f} s (checkpoints {t_ck:.1f}, export {t_ex:.1f})",
          flush=True)
    return counts


# -- ingest: weights and state from outside the port -------------------------

# train_apf.py's model_config: the reference-exact APF (in_channels 4 =
# xyz + height, nsample 32, encoder second width 2E = 1536), in bf16. Its
# encoder lies off the group-MLP kernels' gate (H <= 640) and takes the
# GEMM chain; train_apf.py trains it at batch 32 on 2048-point clouds and
# tests on 1024.
EXACT_APF_CONFIG = {"num_classes": 15, "in_channels": 4, "vit_name": "vit_base_patch16_224", "pretrained": True,
                    "embedding_dim": 768, "npoint": 196, "nsample": 32, "dropout_rate": 0.1,
                    "dropout_path_rate": 0.1, "bf16": True}
EXACT_TRAIN_POINTS, EXACT_TEST_POINTS, INGEST_BATCH = 2048, 1024, 32
# What the JAX loaders count on the hub files below (12 blocks of 12 tensors
# and the final norm; with reference_quirks 8 a block; Pix4Point adds the
# cls token and cls pos; the renderer the patchify, cls token and pos):
# tests/test_torch_pretrained.py pins these against the JAX package.
HUB_COUNTS = {"apf": 146, "apf_quirks": 96, "pix4point": 148, "renderer": 150}
EXACT_SERVING_COUNTERS = ("fps", "knn", "group_encoder_chain", "apf_block", "gemm", "layernorm", "attention")
# Resuming a JAX-format checkpoint: slim2 at batch 64, 3 steps, a checkpoint,
# 3 more, against the same 6 steps without a stop.
RESUME_BATCH, RESUME_STEPS = 64, 3


def timm_state_dict(torch, gen, depth: int, dim: int, tokens: int, classes: int = 1000) -> dict:
    """A seeded timm ViT state dict (torch layouts, timm's names, with the
    patch embedding and the classifier head no loader maps)."""
    rn = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    sd = {"cls_token": rn(1, 1, dim), "pos_embed": rn(1, tokens, dim),
          "patch_embed.proj.weight": rn(dim, 3, 16, 16) * 768**-0.5, "patch_embed.proj.bias": 0.1 * rn(dim),
          "norm.weight": 1 + 0.2 * rn(dim), "norm.bias": 0.1 * rn(dim),
          "head.weight": rn(classes, dim) * dim**-0.5, "head.bias": 0.1 * rn(classes)}
    for i in range(depth):
        p = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + 0.2 * rn(dim), 0.1 * rn(dim)
        for n, (o, k) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                          ("mlp.fc2", (dim, 4 * dim))):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = rn(o, k) * k**-0.5, 0.1 * rn(o)
    return sd


def hf_vit_state_dict(torch, gen, depth: int, dim: int, tokens: int) -> dict:
    """A seeded HuggingFace ``ViTForImageClassification`` state dict of a
    torchvision-shaped ViT (the trunk under ``vit.``, a classifier beside it)."""
    rn = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    sd = {"vit.embeddings.cls_token": rn(1, 1, dim), "vit.embeddings.position_embeddings": rn(1, tokens, dim),
          "vit.embeddings.patch_embeddings.projection.weight": rn(dim, 3, 16, 16) * 768**-0.5,
          "vit.embeddings.patch_embeddings.projection.bias": 0.1 * rn(dim),
          "vit.layernorm.weight": 1 + 0.2 * rn(dim), "vit.layernorm.bias": 0.1 * rn(dim),
          "classifier.weight": rn(1000, dim), "classifier.bias": rn(1000)}
    for i in range(depth):
        p = f"vit.encoder.layer.{i}"
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + 0.2 * rn(dim), 0.1 * rn(dim)
        for n, (o, k) in (("attention.attention.query", (dim, dim)), ("attention.attention.key", (dim, dim)),
                          ("attention.attention.value", (dim, dim)), ("attention.output.dense", (dim, dim)),
                          ("intermediate.dense", (4 * dim, dim)), ("output.dense", (dim, 4 * dim))):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = rn(o, k) * k**-0.5, 0.1 * rn(o)
    return sd


def write_safetensors(path: str, tensors: dict) -> None:
    """f32 tensors in the ``.safetensors`` format: a little-endian u64 header
    length, the JSON header (dtype, shape, byte offsets), the raw bytes."""
    import struct

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for raw in blobs:
            f.write(raw)


def hub_pairs(torch, family: str, sd: dict, quirks: bool = False) -> dict:
    """Port tensor name -> the source tensor its loader must copy there,
    re-laid out: the mapping stated anew, independently of the loaders."""
    out = {}
    if family == "renderer":
        q = lambda i, n: f"vit.encoder.layer.{i}.attention.attention.{n}"  # noqa: E731
        for i in range(12):
            p, t = f"vit.encoder.layer.{i}", f"vit.encoder_layer.{i}"
            for wb in ("weight", "bias"):
                out[f"{t}.self_attention.qkv.{wb}"] = torch.cat([sd[f"{q(i, n)}.{wb}"]
                                                                 for n in ("query", "key", "value")])
                for src, dst in (("layernorm_before", "ln_1"), ("layernorm_after", "ln_2"),
                                 ("attention.output.dense", "self_attention.proj"),
                                 ("intermediate.dense", "mlp.fc1"), ("output.dense", "mlp.fc2")):
                    out[f"{t}.{dst}.{wb}"] = sd[f"{p}.{src}.{wb}"]
        w = sd["vit.embeddings.patch_embeddings.projection.weight"]
        out["vit.conv_proj.weight"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # columns (kh, kw, cin)
        out["vit.conv_proj.bias"] = sd["vit.embeddings.patch_embeddings.projection.bias"]
        out["vit.class_token"] = sd["vit.embeddings.cls_token"]
        out["vit.pos_embedding"] = sd["vit.embeddings.position_embeddings"]
        out["vit.ln.weight"], out["vit.ln.bias"] = sd["vit.layernorm.weight"], sd["vit.layernorm.bias"]
        return out
    trunk = "model." if family == "pix4point" else ""
    attn = "attn" if family == "pix4point" else "attention"
    for i in range(12):
        for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2") + (() if quirks else ("attn.qkv", "attn.proj")):
            for wb in ("weight", "bias"):
                out[f"{trunk}blocks.{i}.{n.replace('attn.', attn + '.')}.{wb}"] = sd[f"blocks.{i}.{n}.{wb}"]
    if not quirks:
        norm = "model.norm" if family == "pix4point" else "encoder_norm"
        out[f"{norm}.weight"], out[f"{norm}.bias"] = sd["norm.weight"], sd["norm.bias"]
    if family == "pix4point":
        out["model.cls_token"], out["model.cls_pos"] = sd["cls_token"], sd["pos_embed"][:, :1]
    return out


def check_hub_load(torch, label: str, model, load, pairs: dict, count: int) -> int:
    """``load(model)`` must return ``count``, copy every tensor of ``pairs``
    bit for bit (as f32) and change nothing else."""
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    n = load(model)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = model.state_dict()
    moved = {k for k, v in after.items() if not torch.equal(v.cpu(), before[k])}
    bad = [k for k, want in pairs.items() if not torch.equal(after[k].cpu(), want.float())]
    if n != count or len(pairs) != count or bad or moved != set(pairs):
        fail(f"{label}: loaded {n} tensors (want {count}, {len(pairs)} mapped); not bit-equal to the file: "
             f"{bad[:4]}; changed beyond the mapped: {sorted(moved - set(pairs))[:4]}, unchanged: "
             f"{sorted(set(pairs) - moved)[:4]}")
    print(f"ingest {label}: {n} tensors loaded in {seconds:.2f} s (the JAX loader's count for these keys: "
          f"{count}), each bit-equal to the file after its re-layout, nothing else changed", flush=True)
    return n


def with_height(pts: np.ndarray) -> np.ndarray:
    """xyz clouds with train_apf.py's fourth channel: the height above each
    cloud's lowest point."""
    h = pts[..., 2:3] - pts[..., 2:3].min(axis=1, keepdims=True)
    return np.concatenate([pts, h], -1).astype(np.float32)


def hub_phase(torch, dev, cache: str) -> dict:
    """(a) Three seeded hub files in the weight cache, each loaded into its
    model on the card through the port's loaders, checked tensor by tensor.
    Returns the APF source state dict (for the training step)."""
    import os

    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.pretrained import (
        load_apf_vit_weights,
        load_pix4point_vit_weights,
        load_state_dict,
        load_torchvision_vit_weights,
    )

    from pointvit_tpu_torch.models import TORCHVISION_VIT_PRESETS

    gen = torch.Generator().manual_seed(SEED + 60)
    # vit_base_patch16_224 and vit_small_patch16_384 (197 and 577 tokens), each at the served model's width
    apf_sd = timm_state_dict(torch, gen, 12, EXACT_APF_CONFIG["embedding_dim"], 197)
    apf_sd = {k: v.to(torch.bfloat16) for k, v in apf_sd.items()}
    torch.save(apf_sd, os.path.join(cache, "vit_base_patch16_224.pth"))
    p4p_name = P4P_CONFIG["pretrained_model"]
    p4p_sd = timm_state_dict(torch, gen, 12, P4P_CONFIG["embed_dim"], 577)
    np.savez(os.path.join(cache, p4p_name + ".npz"), **{k: v.numpy() for k, v in p4p_sd.items()})
    tokens = (RENDERER_CONFIG["img_size"] // 16) ** 2 + 1
    hf_sd = hf_vit_state_dict(torch, gen, 12, TORCHVISION_VIT_PRESETS["vit_b_16"]["embed_dim"], tokens)
    write_safetensors(os.path.join(cache, "vit_b_16.safetensors"), hf_sd)
    read = load_state_dict("vit_b_16")
    if sorted(read) != sorted(hf_sd) or any(not torch.equal(read[k], hf_sd[k]) for k in hf_sd):
        fail("the .safetensors reader did not give back the tensors written")
    sizes = {n: os.path.getsize(os.path.join(cache, n)) / 2**20 for n in sorted(os.listdir(cache))}
    print(f"ingest cache: {json.dumps({k: round(v, 1) for k, v in sizes.items()})} MiB", flush=True)

    apf_up = {k: v.float() for k, v in apf_sd.items()}
    for quirks in (False, True):
        model = build_model(EXACT_APF_CONFIG).to(dev)
        label = "APF exact <- timm vit_base_patch16_224 .pth (bf16)" + (", reference_quirks" if quirks else "")
        check_hub_load(torch, label, model,
                       lambda m, q=quirks: load_apf_vit_weights(m, "vit_base_patch16_224", reference_quirks=q),
                       hub_pairs(torch, "apf", apf_up, quirks), HUB_COUNTS["apf_quirks" if quirks else "apf"])
        del model
    model = build_model(P4P_CONFIG).to(dev)
    check_hub_load(torch, f"Pix4Point vit_small <- timm {p4p_name} .npz", model,
                   lambda m: load_pix4point_vit_weights(m, p4p_name), hub_pairs(torch, "pix4point", p4p_sd),
                   HUB_COUNTS["pix4point"])
    del model
    model = build_model(RENDERER_CONFIG).to(dev)
    check_hub_load(torch, "renderer vit_b_16 <- HF ViT .safetensors", model,
                   lambda m: load_torchvision_vit_weights(m, "vit_b_16"), hub_pairs(torch, "renderer", hf_sd),
                   HUB_COUNTS["renderer"])
    del model
    torch.cuda.empty_cache()
    return apf_up


def exact_train_phase(torch, dev, _build, apf_sd: dict) -> dict:
    """(b) train_apf.py's APF trained from the hub file: kernel and plain
    path at batch 32 of 2048-point clouds (xyz + height); the EMA starts at
    the loaded weights, the frozen trunk stays bit-equal to the file."""
    from pointvit_tpu_torch.models import apf_trainable_mask, build_model
    from pointvit_tpu_torch.pretrained import load_apf_vit_weights
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule

    trunk = hub_pairs(torch, "apf", apf_sd)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    trainers, models = {}, {}
    for path, impl in (("kernel", None), ("plain", "torch")):
        model = build_model(EXACT_APF_CONFIG, implementation=impl)
        randomize(torch, model, torch.Generator().manual_seed(SEED + 61))  # the parts no file holds
        model = model.to(dev)
        load_apf_vit_weights(model, EXACT_APF_CONFIG["vit_name"])
        sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=10, warmup_lr_init=1e-3)
        opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY, trainable_mask=apf_trainable_mask(model))
        trainers[path] = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                                 batch_size=INGEST_BATCH, epochs=1, label_smoothing=LABEL_SMOOTHING,
                                 output_dir=out_dir, seed=SEED, device=dev, train_loader=[], test_loader=[],
                                 save_config_snapshot=False, ema_decay=0.999)
        models[path] = model
        current = dict(model.named_parameters()) | dict(model.named_buffers())
        stale = [n for n, e in trainers[path].ema.items() if not torch.equal(e, current[n].float())]
        loaded = [n for n in trunk if n in trainers[path].ema]
        if stale or not loaded or any(not torch.equal(trainers[path].ema[n].cpu(), trunk[n]) for n in loaded):
            fail(f"ingest training ({path}): the EMA does not start at the loaded weights: {stale[:4]}")
    shutil.rmtree(out_dir)
    trainable = sorted(apf_trainable_mask(models["kernel"]))
    frozen = sorted(n for n in trunk if n not in trainable)
    print(f"ingest training: the EMA starts at the loaded weights ({len(loaded)} loaded tensors train: "
          f"{loaded}); {len(frozen)} loaded trunk tensors frozen", flush=True)
    init = {n: p.detach().cpu().clone() for n, p in models["kernel"].named_parameters()}
    rng = np.random.default_rng(SEED + 61)
    batches = []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        pts, lbl = shape_clouds(rng, INGEST_BATCH, EXACT_APF_CONFIG["num_classes"], EXACT_TRAIN_POINTS)
        batches.append((torch.from_numpy(with_height(pts)).to(dev), torch.from_numpy(lbl).to(dev)))
    res = train_paths(torch, _build, trainers, batches, trainable)
    lk, lp = res["losses"]["kernel"], res["losses"]["plain"]
    d = abs(lk[0] - lp[0]) / abs(lp[0])
    print(f"ingest training losses: kernel path {lk}, plain path {lp}; first loss |d| / |plain| {d:.3g} "
          f"(bound {TRAIN_LOSS_REL_TOL})", flush=True)
    if not all(np.isfinite(lk + lp)) or not d <= TRAIN_LOSS_REL_TOL:
        fail("ingest training: a loss is not finite, or the first disagrees between the paths")
    for path, model in models.items():
        own = dict(model.named_parameters())
        changed = [n for n in frozen if not torch.equal(own[n].detach().cpu(), trunk[n])]
        still = [n for n in trainable if torch.equal(own[n].detach().cpu(), init[n])]
        if changed or still:
            fail(f"ingest training ({path}): frozen trunk tensors moved from the file {changed[:4]}, "
                 f"or trainable ones did not move {still[:4]}")
    print(f"ingest training: {len(frozen)} frozen trunk tensors bit-equal to the file on both paths after "
          f"{len(lk)} steps; every trainable tensor moved", flush=True)
    print(f"ingest training launches during the timed steps: {json.dumps(res['counts'])}", flush=True)
    for name in TRAINING_COUNTERS:
        if res["counts"].get(name, 0) <= 0:
            fail(f"the ingest training path never launched the {name} kernel")
    print(f"ingest training APF exact (train_apf.py) from the hub file at batch {INGEST_BATCH} x "
          f"{EXACT_TRAIN_POINTS} points: {step_line(res, INGEST_BATCH)}", flush=True)
    del trainers, models
    torch.cuda.empty_cache()
    return res["counts"]


def reference_phase(torch, dev, _build, tmp: str) -> list:
    """(c) Seeded reference-layout checkpoints of APF exact, Pix4Point
    vit_small and the renderer vit_b_16 (learned views), each served by
    ``Classifier.for_family(reference_checkpoint=)`` on the card against the
    plain path loaded from the same file; returns the launch counts."""
    import os

    from pointvit_tpu_torch.inference import Classifier
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch import pretrained
    from pointvit_tpu_torch.pretrained.reference_ckpt import reference_state_dict

    rng = np.random.default_rng(SEED + 62)
    cases = (
        ("apf", "APF exact", EXACT_APF_CONFIG, with_height(rng.standard_normal(
            (INGEST_BATCH, EXACT_TEST_POINTS, 3)).astype(np.float32)), EXACT_SERVING_COUNTERS,
         pretrained.load_reference_apf_checkpoint),
        ("pix4point", "Pix4Point vit_small", P4P_CONFIG,
         rng.standard_normal((INGEST_BATCH, P4P_POINTS, 3)).astype(np.float32), P4P_COUNTERS,
         pretrained.load_reference_pix4point_checkpoint),
        ("renderer", "renderer vit_b_16", RENDERER_CONFIG,
         unit_sphere(rng.standard_normal((INGEST_BATCH, RENDERER_POINTS, 3))), RENDERER_COUNTERS,
         pretrained.load_reference_renderer_checkpoint),
    )
    counts = []
    for i, (family, label, cfg, clouds, counters, load) in enumerate(cases):
        source = build_model(cfg, family)
        randomize(torch, source, torch.Generator().manual_seed(SEED + 63 + i))
        path = os.path.join(tmp, f"reference_{family}.pth")
        sd = reference_state_dict(source, family)
        torch.save({"model_state_dict": sd, "epoch": 99}, path)
        t0 = time.perf_counter()
        clf = Classifier.for_family(family, cfg, reference_checkpoint=path, batch_size=INGEST_BATCH, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        plain = build_model(cfg, family, implementation="torch")
        n, missing = load(plain, path)
        if missing:
            fail(f"reference {label}: {len(missing)} tensors missing from the file: {missing[:4]}")
        want_sd = source.state_dict()
        bad = [k for k, v in clf.model.state_dict().items() if not torch.equal(v.cpu(), want_sd[k])]
        if bad:
            fail(f"reference {label}: the served model differs from the file's weights at {bad[:4]}")
        pclf = Classifier(plain, batch_size=INGEST_BATCH, device=dev)
        clf.logits(clouds)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = clf.logits(clouds)
        torch.cuda.synchronize()
        counts.append(_build.launch_counts())
        want = pclf.logits(clouds)
        serving_gate(f"reference {label} ({len(sd)} tensors in the file, {n} loaded, none missing)", got, want)
        for name in counters:
            if counts[-1].get(name, 0) <= 0:
                fail(f"reference {label}: the serving path never launched the {name} kernel")
        ms = cuda_ms(torch, lambda: clf.logits(clouds), 3)
        pms = cuda_ms(torch, lambda: pclf.logits(clouds), 1)
        print(f"reference {label}: Classifier.for_family(reference_checkpoint=) built in {t_build:.2f} s "
              f"({os.path.getsize(path) / 2**20:.1f} MiB file: read, build_model, load, to the card); a request "
              f"of {INGEST_BATCH}: kernel path {ms:.3f} ms, plain path {pms:.3f} ms; launches "
              f"{json.dumps(counts[-1])}", flush=True)
        del clf, pclf, plain, source
        torch.cuda.empty_cache()
    return counts


def resume_phase(torch, dev, _build, tmp: str) -> dict:
    """(d) slim2 trained 3 steps in the port, written as a JAX trainer's
    msgpack (the optax layout of APF's masked AdamW, through
    ``adamw_to_optax``), resumed by a fresh ``Trainer`` and trained 3 more
    steps: against the same run carried on without a stop. A JAX checkpoint
    holds no generator state, so the carried-on run's draws are handed to
    the resumed one."""
    from pointvit_tpu_torch.convert import adamw_to_optax, state_dict_to_flax
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config, apf_trainable_mask
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule
    from pointvit_tpu_torch.train.checkpoint import save_checkpoint

    cfg = apf_preset_config("slim2", num_classes=TRAIN_CLASSES)

    def trainer(seed):
        model = AdaptPointFormer(**cfg)
        randomize(torch, model, torch.Generator().manual_seed(seed))
        sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=5, warmup_lr_init=1e-3)
        opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY, trainable_mask=apf_trainable_mask(model))
        return Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                       batch_size=RESUME_BATCH, epochs=3, label_smoothing=LABEL_SMOOTHING, output_dir=tmp,
                       seed=SEED, device=dev, train_loader=[], test_loader=[], save_config_snapshot=False,
                       ema_decay=0.99)

    rng = np.random.default_rng(SEED + 64)
    batches = []
    for _ in range(2 * RESUME_STEPS):
        pts, lbl = shape_clouds(rng, RESUME_BATCH, TRAIN_CLASSES)
        batches.append((torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)))
    run = trainer(SEED + 64)
    for b in batches[:RESUME_STEPS]:
        run.train_step(*b)
    draws = run.generator.get_state()
    t0 = time.perf_counter()
    tree = state_dict_to_flax(run.model)
    averaged = AdaptPointFormer(**cfg)
    averaged.load_state_dict({**{k: v.cpu() for k, v in run.model.state_dict().items()},
                              **{k: v.cpu() for k, v in run.ema.items()}})
    ema = state_dict_to_flax(averaged)
    opt_state = adamw_to_optax(run.model, run.optimizer)
    path = save_checkpoint(tmp, "model_epoch_1.msgpack", epoch=0, accuracy=0.5,
                           state={**tree, "opt_state": opt_state, "step": run.step,
                                  "ema_params": ema["params"], "ema_batch_stats": ema["batch_stats"]},
                           model_config={**SLIM2_MODEL_CONFIG, "num_classes": TRAIN_CLASSES},
                           dataset_config={"name": "synthetic"})
    t_write = time.perf_counter() - t0
    adam = opt_state["inner_states"]["True"]["inner_state"]["0"]["0"]
    leaves = lambda t: [v for x in t.values() for v in (leaves(x) if isinstance(x, dict) else [x])]  # noqa: E731
    masked = lambda t: sum(masked(x) if x else 1 for x in t.values() if isinstance(x, dict))  # noqa: E731
    moments = (len(leaves(adam["mu"])), masked(adam["mu"]))
    for b in batches[RESUME_STEPS:]:
        run.train_step(*b)

    resumed = trainer(SEED + 65)
    t0 = time.perf_counter()
    resumed.load_checkpoint(path)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    if resumed.step != RESUME_STEPS or resumed.start_epoch != 1:
        fail(f"resume: step {resumed.step}, start epoch {resumed.start_epoch} after the restore")
    resumed.generator.set_state(draws)
    _build.reset_launch_counts()
    for b in batches[RESUME_STEPS:]:
        resumed.train_step(*b)
    torch.cuda.synchronize()
    counts = _build.launch_counts()

    after = resumed.model.state_dict()
    pairs = [(f"weights {k}", v, after[k]) for k, v in run.model.state_dict().items()]
    pairs += [(f"EMA {k}", v, resumed.ema[k]) for k, v in run.ema.items()]
    s1, s2 = run.optimizer.optimizer.state_dict()["state"], resumed.optimizer.optimizer.state_dict()["state"]
    if sorted(s1) != sorted(s2) or run.optimizer.count != resumed.optimizer.count:
        fail("resume: the optimizer states hold different parameters or counts")
    pairs += [(f"Adam {k}.{f}", s1[k][f], s2[k][f]) for k in s1 for f in ("step", "exp_avg", "exp_avg_sq")]
    differ = [(rel_l2(b, a), name) for name, a, b in pairs if not torch.equal(a, b)]
    print(f"resume: slim2 at batch {RESUME_BATCH}: {RESUME_STEPS} steps, a JAX-format checkpoint "
          f"(mu and nu for {moments[0]} trainable tensors, MaskedNode for {moments[1]} frozen, Adam count "
          f"{int(adam['count'])}, written in {t_write:.2f} s, "
          f"resumed in {t_read:.2f} s), {RESUME_STEPS} more; against the run carried on: {len(pairs)} tensors "
          f"(weights, BatchNorm statistics, EMA, Adam state), {len(differ)} differ"
          + (f", worst relative L2 {max(differ)[0]:.3g} at {max(differ)[1]}" if differ else ", all bit-equal"),
          flush=True)
    if differ:
        fail(f"resume: the resumed run differs from the run carried on: {sorted(differ)[-4:]}")
    for name in TRAINING_COUNTERS:
        if counts.get(name, 0) <= 0:
            fail(f"the resumed training path never launched the {name} kernel")
    del run, resumed, averaged
    torch.cuda.empty_cache()
    return counts


def ingest_phase(torch, dev, _build, smi: str) -> list:
    """Weights and state from outside the port, on the card; returns the
    launch counts of its paths."""
    import os

    t0 = time.perf_counter()
    saved = os.environ.get("POINTVIT_WEIGHTS")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as tmp:
        cache = os.path.join(tmp, "weights")
        os.makedirs(cache)
        os.environ["POINTVIT_WEIGHTS"] = cache
        try:
            apf_sd = hub_phase(torch, dev, cache)
            t_hub = time.perf_counter() - t0
            counts = [exact_train_phase(torch, dev, _build, apf_sd)]
            t_train = time.perf_counter() - t0 - t_hub
            counts += reference_phase(torch, dev, _build, tmp)
            t_ref = time.perf_counter() - t0 - t_hub - t_train
            counts.append(resume_phase(torch, dev, _build, tmp))
        finally:
            if saved is None:
                os.environ.pop("POINTVIT_WEIGHTS", None)
            else:
                os.environ["POINTVIT_WEIGHTS"] = saved
    print(f"ingest phase on {smi}: {time.perf_counter() - t0:.1f} s (hub files {t_hub:.1f}, training "
          f"{t_train:.1f}, reference checkpoints {t_ref:.1f})", flush=True)
    return counts


def apf_long_phase(torch, dev, _build, base, npoint, batch, points, seed, need, unused,
                   preset="slim2") -> dict:
    """APF ``preset`` (slim2) with ``npoint`` tokens on ``base``'s weights,
    serving one request of ``batch`` clouds of ``points`` points on the
    kernel path and the plain path. The counters in ``need`` must launch and
    those in ``unused`` must not. Returns the launch counts, block 0 and
    block 0's input tokens."""
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config
    from pointvit_tpu_torch.serve import InferenceSession

    cfg = apf_preset_config(preset, npoint=npoint)
    label = f"apf npoint {npoint}" if preset == "slim2" else f"apf {preset}"
    model = AdaptPointFormer(**cfg)
    plain = AdaptPointFormer(**cfg, implementation="torch")
    model.load_state_dict(base.state_dict())
    plain.load_state_dict(base.state_dict())
    sess = InferenceSession(model, buckets=(batch,), device=dev)
    psess = InferenceSession(plain, buckets=(batch,), device=dev)
    rng = np.random.default_rng(seed)
    req = rng.standard_normal((batch, points, 3)).astype(np.float32)
    sess.warmup(req[0])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    tokens = []
    hook = model.blocks[0].register_forward_pre_hook(lambda _, a: tokens.append(a[0]))
    try:
        got = sess.predict_logits(req)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"{label} launches during serving: {json.dumps(counts)}", flush=True)
    want = psess.predict_logits(req)
    if got.shape != (batch, cfg["num_classes"]) or not np.isfinite(got).all():
        fail(f"{label} logits: shape {got.shape}, finite {np.isfinite(got).all()}")
    same, gap, decided = untied(got, want)
    agree = float(same[decided].mean()) if decided.any() else 1.0
    dlogit = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{label} serving: one request of {batch} clouds of {points} "
          f"points: argmax agreement {same.mean():.4f} over all (top-2 plain-path gaps of the "
          f"{int((~same).sum())} that differ: {[float(v) for v in gap[~same]]}), {agree:.4f} over the "
          f"{int(decided.sum())} whose gap exceeds {BF16_REL_TOL * scale:.4g} (need >= "
          f"{ARGMAX_AGREEMENT}); max|dlogit| {dlogit:.6g} vs max|logit| {scale:.6g} (bound "
          f"{LOGIT_REL_TOL} x max|logit|)", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail(f"{label} kernel-path logits disagree with the plain path")
    for name in need:
        if counts.get(name, 0) <= 0:
            fail(f"the {label} serving path never launched the {name} kernel")
    for name in unused:
        if counts.get(name, 0):
            fail(f"the {label} serving path launched {name}, which it must leave")
    tp1 = cuda_ms(torch, lambda: psess.predict_logits(req), 1)
    tk1 = cuda_ms(torch, lambda: sess.predict_logits(req), 3)
    tk2 = cuda_ms(torch, lambda: sess.predict_logits(req), 3)
    tp2 = cuda_ms(torch, lambda: psess.predict_logits(req), 1)
    print(f"{label} request of {batch}: kernel path {(tk1 + tk2) / 2:.3f} ms "
          f"(runs {tk1:.3f}, {tk2:.3f}), plain path {(tp1 + tp2) / 2:.3f} ms (runs {tp1:.3f}, "
          f"{tp2:.3f})", flush=True)
    del psess, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "block": model.blocks[0], "tokens": tokens[0]}


def nsample_phase(torch, _build, encoder_kernel, apf_group, xyz, G, w) -> None:
    """C5 on slim2's widths: the group encoder at nsample 24, its groups
    padded to 32 rows for the group-MLP kernels, held against its plain
    version (2^-6 of max|ref|, two runs bit-equal) and timed beside nsample
    32 on the same clouds and weights."""
    B = xyz.shape[0]
    xs = {K: apf_group(xyz, xyz, G, K)[0].to(torch.bfloat16).reshape(B * G, K, -1).contiguous()
          for K in (24, 32)}
    run = {K: (lambda x=x: encoder_kernel.fused_group_encoder(x, w)) for K, x in xs.items()}
    _build.reset_launch_counts()
    got = run[24]()
    counts = _build.launch_counts()
    if counts["group_encoder"] != 1 or counts["group_encoder_chain"]:
        fail(f"group_encoder at nsample 24 did not take the group-MLP kernels: {counts}")
    again = run[24]()
    torch.cuda.synchronize()
    d, r = rel_err(torch, got, encoder_kernel.reference_folded_encoder(xs[24], w))
    if not torch.equal(got, again):
        fail("group_encoder at nsample 24: two runs differ")
    if not r <= BF16_REL_TOL:
        fail("group_encoder at nsample 24 disagrees with its plain version")
    ms = {K: cuda_ms(torch, fn, 5) for K, fn in run.items()}
    print(f"group_encoder at nsample 24 {tuple(xs[24].shape)} (groups padded to 32, the group-MLP "
          f"kernels): max|d| {d:.6g}, relative to max|ref| {r:.3g} (bound {BF16_REL_TOL:.3g}), two runs "
          f"bit-equal; {ms[24]:.4f} ms against {ms[32]:.4f} ms at nsample 32 ({ms[24] / ms[32]:.3f}x; "
          f"nsample 24 does 24/32 of that work)", flush=True)


def f32_serving_phase(torch, dev, _build, label, make, state, points, seed, need) -> dict:
    """An f32 model (``make(implementation)``) on ``state``'s weights serves
    one request of F32_BATCH clouds of ``points`` points on the kernel path
    and the plain path (both f32): logits within F32_LOGIT_REL_TOL of the
    largest, argmax equal on ARGMAX_AGREEMENT of the clouds; the counters in
    ``need`` launch, the bf16 GEMM and attention never. Returns the counts
    and block 0's input tokens (for the kernel line)."""
    from pointvit_tpu_torch.serve import InferenceSession

    model, plain = make(None), make("torch")
    model.load_state_dict(state)
    plain.load_state_dict(state)
    sess = InferenceSession(model, buckets=(F32_BATCH,), device=dev)
    psess = InferenceSession(plain, buckets=(F32_BATCH,), device=dev)
    req = np.random.default_rng(seed).standard_normal((F32_BATCH, points, 3)).astype(np.float32)
    sess.warmup(req[0])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    tokens = []
    blocks = model.blocks if hasattr(model, "blocks") else model.model.blocks
    hook = blocks[0].register_forward_pre_hook(lambda _, a, kw=None: tokens.append(a[0]))
    try:
        got = sess.predict_logits(req)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"{label} f32 launches during serving: {json.dumps(counts)}", flush=True)
    want = psess.predict_logits(req)
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{label} f32 logits: shape {got.shape}, finite {np.isfinite(got).all()}")
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    dlogit, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    tk = cuda_ms(torch, lambda: sess.predict_logits(req), 2)
    tp = cuda_ms(torch, lambda: psess.predict_logits(req), 2)
    print(f"{label} f32 serving, one request of {F32_BATCH} clouds of {points} points: argmax "
          f"agreement {agree:.4f} (need >= {ARGMAX_AGREEMENT}), max|dlogit| {dlogit:.6g} vs max|logit| "
          f"{scale:.6g} (bound {F32_LOGIT_REL_TOL} x max|logit|); kernel path {tk:.3f} ms, plain path "
          f"{tp:.3f} ms", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > F32_LOGIT_REL_TOL * scale:
        fail(f"{label} f32 kernel-path logits disagree with the plain path")
    for name in need:
        if counts.get(name, 0) <= 0:
            fail(f"the {label} f32 serving path never launched the {name} kernel")
    for name in ("gemm", "attention", "mha_qkv", *GROUP_MLP_COUNTERS):
        if counts.get(name, 0):
            fail(f"the {label} f32 serving path launched the bf16 kernel {name}")
    del sess, psess, model, plain
    torch.cuda.empty_cache()
    return {"counts": counts, "tokens": tokens[0], "block": blocks[0]}


def small_model_phase(torch, dev, _build) -> dict:
    """The train_step_bench small config (E 64, 4 heads of 16, f32, npoint
    32, 256 points) at batch 256: one request served on both paths, then
    SMALL_STEPS training steps on both paths from the same weights, batch
    and draws (f32: first loss within F32_LOSS_REL_TOL, first-step
    gradients within F32_GRAD_REL_TOL relative L2 of the plain path's). The
    any-head-dim attention forward and backward must launch. Returns the
    serving and training counts and block 0's qkv."""
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
    from pointvit_tpu_torch.nn.layers import layer_norm, linear
    from pointvit_tpu_torch.serve import InferenceSession
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule

    cfg = dict(SMALL_CONFIG, dtype=torch.float32)
    models = {"kernel": AdaptPointFormer(**cfg), "plain": AdaptPointFormer(**cfg, implementation="torch")}
    randomize(torch, models["kernel"], torch.Generator().manual_seed(SEED + 20))
    models["plain"].load_state_dict(models["kernel"].state_dict())
    state = {k: v.clone() for k, v in models["kernel"].state_dict().items()}
    rng = np.random.default_rng(SEED + 20)
    pts, lbl = shape_clouds(rng, TRAIN_BATCH, SMALL_CONFIG["num_classes"], SMALL_POINTS)

    sess = InferenceSession(models["kernel"], buckets=(TRAIN_BATCH,), device=dev)
    psess = InferenceSession(models["plain"], buckets=(TRAIN_BATCH,), device=dev)
    sess.warmup(pts[0])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    tokens = []
    hook = models["kernel"].blocks[0].register_forward_pre_hook(lambda _, a: tokens.append(a[0]))
    try:
        got = sess.predict_logits(pts)
    finally:
        hook.remove()
    torch.cuda.synchronize()
    serve_counts = _build.launch_counts()
    want = psess.predict_logits(pts)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    dlogit, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    tk = cuda_ms(torch, lambda: sess.predict_logits(pts), 3)
    tp = cuda_ms(torch, lambda: psess.predict_logits(pts), 3)
    print(f"head dim 16 model (E 64, 4 heads, f32) serving {TRAIN_BATCH} clouds: argmax agreement "
          f"{agree:.4f}, max|dlogit| {dlogit:.6g} vs max|logit| {scale:.6g} (bound "
          f"{F32_LOGIT_REL_TOL} x); kernel path {tk:.3f} ms, plain path {tp:.3f} ms; launches "
          f"{json.dumps(serve_counts)}", flush=True)
    if not np.isfinite(got).all() or agree < ARGMAX_AGREEMENT or dlogit > F32_LOGIT_REL_TOL * scale:
        fail("the head dim 16 model's kernel-path logits disagree with the plain path")
    for name in ("attention_any", "gemm_f32", "group_encoder_chain"):
        if serve_counts.get(name, 0) <= 0:
            fail(f"the head dim 16 model's serving never launched {name}")
    blk = models["kernel"].blocks[0]
    with torch.inference_mode():
        qkv = linear(layer_norm(tokens[0], blk.norm1), blk.attention.qkv).contiguous()
    del sess, psess

    trainable = sorted(apf_trainable_mask(models["kernel"]))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_small_")
    x, y = torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)
    res = {"loss": {}, "grads": {}, "ms": {}}
    for path, model in models.items():
        model.load_state_dict(state)
        sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=5, warmup_lr_init=1e-3)
        opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY,
                              trainable_mask=apf_trainable_mask(model))
        tr = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                     batch_size=TRAIN_BATCH, epochs=1, label_smoothing=LABEL_SMOOTHING,
                     output_dir=out_dir, seed=SEED, device=dev, train_loader=[], test_loader=[],
                     save_config_snapshot=False)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        losses = [tr.train_step(x, y)[0]]
        res["grads"][path] = {n: p.grad.detach().clone()
                              for n, p in tr.model.named_parameters() if n in trainable}
        t0.record()
        for _ in range(SMALL_STEPS - 1):
            losses.append(tr.train_step(x, y)[0])
        t1.record()
        torch.cuda.synchronize()
        res["ms"][path] = t0.elapsed_time(t1) / (SMALL_STEPS - 1)
        if path == "kernel":
            res["counts"] = _build.launch_counts()
        res["loss"][path] = [v.item() for v in losses]
        del tr, opt
    shutil.rmtree(out_dir)
    lk, lp = res["loss"]["kernel"], res["loss"]["plain"]
    d = abs(lk[0] - lp[0]) / abs(lp[0])
    gk, gp = res["grads"]["kernel"], res["grads"]["plain"]
    flat = lambda g: torch.cat([g[n].float().flatten() for n in trainable])  # noqa: E731
    err = rel_l2(flat(gk), flat(gp))
    print(f"head dim 16 model training, {SMALL_STEPS} steps of {TRAIN_BATCH} clouds: losses kernel "
          f"path {lk}, plain path {lp}; first loss |d| / |plain| {d:.3g} (bound {F32_LOSS_REL_TOL}); "
          f"first-step gradients of {len(trainable)} trainable tensors, relative L2 {err:.3g} (bound "
          f"{F32_GRAD_REL_TOL}); kernel path {res['ms']['kernel']:.3f} ms/step, plain path "
          f"{res['ms']['plain']:.3f} ms/step; launches {json.dumps(res['counts'])}", flush=True)
    if not (np.isfinite(lk + lp).all() and d <= F32_LOSS_REL_TOL and err <= F32_GRAD_REL_TOL):
        fail("the head dim 16 model's training disagrees between the kernel and plain paths")
    for name in ("attention_any", "attention_any_bwd"):
        if res["counts"].get(name, 0) <= 0:
            fail(f"the head dim 16 model's training never launched {name}")
    del models
    torch.cuda.empty_cache()
    return {"serve_counts": serve_counts, "train_counts": res["counts"], "qkv": qkv}


def attention_any_case(torch, label, qkv, heads, seed, iters=3) -> dict:
    """``csrc/attention_any.cu`` forward and backward on ``qkv`` with a seeded
    cotangent: out, dq, dk and dv each within its tolerance of its own
    max|ref| of the plain version (f32 F32_REL_TOL, bf16 BF16_REL_TOL), two
    runs bit-equal; then timed beside its bound (useful FLOPs 4 B S^2 E
    forward, 10 B S^2 E backward; f32 as 3xTF32 at PEAK_TF32, bf16 at
    PEAK_BF16; the f32 CUDA-core figure too) and SDPA forward and backward
    on the same inputs (timed only). Returns the kernel-line entries of
    both directions."""
    from pointvit_tpu_torch import _build
    from pointvit_tpu_torch.ops import attention_kernel

    B, S, E3 = qkv.shape
    E, dt = E3 // 3, qkv.dtype
    g = torch.randn((B, S, E), generator=torch.Generator().manual_seed(seed)).to(qkv.device, dt)
    tol = BF16_REL_TOL if dt == torch.bfloat16 else F32_REL_TOL
    with torch.inference_mode():
        _build.reset_launch_counts()
        out, out2 = (attention_kernel.mha_qkv(qkv, heads) for _ in range(2))
        dq, dq2 = (attention_kernel.mha_qkv_bwd(qkv, g, heads) for _ in range(2))
        counts = _build.launch_counts()
        ref = attention_kernel.reference_mha_qkv(qkv, heads)
        dref = attention_kernel.reference_mha_qkv_bwd(qkv, g, heads)
        torch.cuda.synchronize()
        if counts.get("attention_any") != 2 or counts.get("attention_any_bwd") != 2:
            fail(f"attention_any {label}: the any-head-dim kernels did not take it ({counts})")
        if not (torch.equal(out, out2) and torch.equal(dq, dq2)):
            fail(f"attention_any {label}: two runs differ")
        if not (torch.isfinite(out).all() and torch.isfinite(dq).all()):
            fail(f"attention_any {label}: not finite")
        errs = [rel_err(torch, out, ref)] + [
            rel_err(torch, dq[..., i * E:(i + 1) * E], dref[..., i * E:(i + 1) * E]) for i in range(3)]
        if not max(e[1] for e in errs) <= tol:
            fail(f"attention_any {label}: {max(e[1] for e in errs):.3g} of max|ref| from its plain version "
                 f"(bound {tol:.3g})")
        del out2, dq2
        flops = 4.0 * B * S * S * E
        peak = PEAK_TF32 / 3 if dt == torch.float32 else PEAK_BF16
        fwd = dict(shape=f"{tuple(qkv.shape)}, {heads} heads, {str(dt)[6:]}", max_abs_err=errs[0][0],
                   ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv(qkv, heads), iters),
                   plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv(qkv, heads), 1),
                   **bound(flops, nbytes(qkv, out), peak), flops=flops)
        bwd = dict(shape=fwd["shape"], max_abs_err=max(e[0] for e in errs[1:]),
                   ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv_bwd(qkv, g, heads), iters),
                   plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv_bwd(qkv, g, heads), 1),
                   **bound(2.5 * flops, nbytes(qkv, g, dq), peak), flops=2.5 * flops)
        q, k, v = heads_of(qkv, heads)
        fwd["library_ms"] = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                                    iters)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = g.reshape(B, S, heads, -1).transpose(1, 2).contiguous()
    bwd["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True), iters)
    for name, r in (("forward", fwd), ("backward", bwd)):
        cores = f"; f32 CUDA cores {r['flops'] / PEAK_F32 * 1e3:.4f}" if dt == torch.float32 else ""
        print(f"attention_any {label} {name} {r['shape']}: out, dq, dk, dv against max|ref| "
              f"{', '.join(f'{e[1]:.3g}' for e in errs)} (bound {tol:.3g}), repeats bit-equal; kernel "
              f"{r['ms']:.4f} ms, {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}{cores}), SDPA {r['library_ms']:.4f} ms "
              f"({r['ms'] / r['library_ms']:.2f}x), plain {r['plain_ms']:.4f} ms", flush=True)
    del q, k, v, o, go, g, out, dq, ref, dref
    torch.cuda.empty_cache()
    return {"attention_any": fwd, "attention_any_bwd": bwd}


def attention_any_phase(torch, dev) -> list:
    """``attention_any_case`` at head dims 8, 16, 32 and 128, bf16 and f32, on
    seeded (ANY_BATCH, ANY_SEQ, 3 ANY_WIDTH) inputs."""
    rows = []
    for D in ANY_HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator().manual_seed(SEED + 30 + D)
            qkv = (2.0 * torch.randn(ANY_BATCH, ANY_SEQ, 3 * ANY_WIDTH, generator=gen)).to(dev, dt)
            rows.append(attention_any_case(torch, f"D={D}", qkv, ANY_WIDTH // D, SEED + 31 + D))
            del qkv
    return rows


def p3_off_shape_phase(torch, dev, _build, model) -> dict:
    """Pix4Point (the served bf16 model) on one cloud of 1000 points (S =
    250) and on a bucket-8 request of 1004-point clouds (S = 251): B S % 16
    != 0, so P3Embed runs stage_unfused, as the JAX module does; the p3_embed
    kernel must not launch, the blocks' must. Logits held against the plain
    path as the other bf16 requests of a few clouds are (untied argmax)."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    plain = build_model(P4P_CONFIG, implementation="torch")
    plain.load_state_dict(model.state_dict())
    sess = InferenceSession(model, buckets=(1, 8), device=dev)
    psess = InferenceSession(plain, buckets=(1, 8), device=dev)
    rng = np.random.default_rng(SEED + 40)
    counts = {}
    for n, points in P4P_OFF_SHAPES:
        req = rng.standard_normal((n, points, 3)).astype(np.float32)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = sess.predict_logits(req)
        torch.cuda.synchronize()
        c = _build.launch_counts()
        want = psess.predict_logits(req)
        same, gap, decided = untied(got, want)
        agree = float(same[decided].mean()) if decided.any() else 1.0
        dlogit, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"pix4point {n} cloud(s) of {points} points (S = {points // 4}): p3_embed launches "
              f"{c.get('p3_embed', 0)}, vit_block {c.get('vit_block', 0)}; argmax agreement "
              f"{agree:.4f} over the {int(decided.sum())} untied, max|dlogit| {dlogit:.6g} vs "
              f"max|logit| {scale:.6g} (bound {LOGIT_REL_TOL} x)", flush=True)
        if got.shape != (n, P4P_CONFIG["num_classes"]) or not np.isfinite(got).all():
            fail(f"pix4point at {points} points: shape {got.shape}, finite {np.isfinite(got).all()}")
        if c.get("p3_embed", 0) or c.get("vit_block", 0) <= 0:
            fail(f"pix4point at {points} points took the P3 kernel or left the block kernels")
        if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
            fail(f"pix4point at {points} points: kernel-path logits disagree with the plain path")
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
    del plain, psess
    return counts


def vit_split(torch, x0, w, heads, pos) -> dict:
    """Row 8's chain, launch by launch, on block 0's inputs: pos-LayerNorm,
    qkv, attention, proj + LN2 (one launch), fc1, fc2, each timed alone
    (CUDA events) beside its bound; and, beside them, proj and LN2 as the
    two launches they were. The products are the GEMM phase's rows. Returns
    the split and the proj + LN2 launch's kernel-line entry."""
    from pointvit_tpu_torch.ops import block_kernel, vit_block_kernel
    from pointvit_tpu_torch.ops.gemm_kernel import gemm

    B, S, E = x0.shape
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, wfc1, bfc1, wfc2, bfc2 = w
    x2 = x0.reshape(B * S, E).contiguous()
    table = vit_block_kernel._pos_table(pos, B, S, E).contiguous()
    xp, h = block_kernel.pos_layer_norm(x2, table, g1, b1)
    qkv, _ = gemm(h, wqkv, bqkv)
    att = block_kernel.attention(qkv.reshape(B, S, 3 * E), heads).reshape(B * S, E)
    x1, h2 = vit_block_kernel.proj_layer_norm(att, wproj, bproj, xp, g2, b2)
    want = vit_block_kernel.reference_proj_layer_norm(att, wproj, bproj, xp, g2, b2)
    errs = [rel_err(torch, got, ref) for got, ref in zip((x1, h2), want)]
    print(f"proj + LN2 one launch ({B * S}, {E}): x1, LN2(x1) max|d| / max|ref| "
          f"{errs[0][1]:.3g}, {errs[1][1]:.3g} (bound {BF16_REL_TOL:.3g})", flush=True)
    if not max(e[1] for e in errs) <= BF16_REL_TOL:
        fail("proj_layernorm disagrees with its plain version")
    h3, _ = gemm(h2, wfc1, bfc1, act="gelu")
    proj_ln = lambda: vit_block_kernel.proj_layer_norm(att, wproj, bproj, xp, g2, b2)  # noqa: E731
    steps = {
        "pos_layernorm": (lambda: block_kernel.pos_layer_norm(x2, table, g1, b1), 0.0,
                          nbytes(x2, table, xp, h)),
        "qkv": (lambda: gemm(h, wqkv, bqkv), 2.0 * B * S * wqkv.numel(), nbytes(h, wqkv, qkv)),
        "attention": (lambda: block_kernel.attention(qkv.reshape(B, S, 3 * E), heads),
                      4.0 * B * S * S * E, nbytes(qkv, att)),
        "proj_layernorm": (proj_ln, 2.0 * B * S * wproj.numel(), nbytes(att, wproj, xp, x1, h2)),
        "fc1": (lambda: gemm(h2, wfc1, bfc1, act="gelu"), 2.0 * B * S * wfc1.numel(),
                nbytes(h2, wfc1, h3)),
        "fc2": (lambda: gemm(h3, wfc2, bfc2, res=x1), 2.0 * B * S * wfc2.numel(),
                nbytes(h3, wfc2, x1, x1)),
    }
    split = {name: dict(ms=cuda_ms(torch, fn, 10), **bound(flops, moved))
             for name, (fn, flops, moved) in steps.items()}
    apart = {"proj": cuda_ms(torch, lambda: gemm(att, wproj, bproj, res=xp), 10),
             "layernorm": cuda_ms(torch, lambda: block_kernel.layer_norm(x1, g2, b2), 10)}
    total = sum(r["ms"] for r in split.values())
    print("vit block split (block 0 of the served Pix4Point, CUDA events per launch, ms [bound]): "
          + ", ".join(f"{k} {v['ms']:.4f} [{v['bound_ms']:.4f} {v['bound_by']}]" for k, v in split.items())
          + f"; sum {total:.4f}; proj and LN2 as two launches: {apart['proj']:.4f} + "
          f"{apart['layernorm']:.4f}", flush=True)
    line = dict(shape=f"proj ({B * S}, {E}) -> {E} + residual + LN2", max_abs_err=errs[1][0],
                ms=split["proj_layernorm"]["ms"],
                plain_ms=cuda_ms(torch, lambda: vit_block_kernel.reference_proj_layer_norm(
                    att, wproj, bproj, xp, g2, b2), 3),
                bound_ms=split["proj_layernorm"]["bound_ms"], bound_by=split["proj_layernorm"]["bound_by"],
                library_ms=None)
    return {"split": split, "line": line}


def launch_weight_saving(torch, label, blocks, make) -> float:
    """The ms a request saves by keeping the blocks' launch-ready weights:
    the re-cast of every block's weights, timed alone (CUDA events)."""
    ms = cuda_ms(torch, lambda: [make(b) for b in blocks], 5)
    print(f"{label}: re-casting the {len(blocks)} blocks' launch weights takes {ms:.4f} ms, which "
          f"each request saves now that the blocks keep them", flush=True)
    return ms


class RoutingProbe:
    """Wraps ``parallel/expert.py``'s ``_route``: records the (K, T) expert
    picks of each watched MoE layer's first forward, and with ``force`` set
    to a label, replaces a forward's picks with that label's recorded ones.
    The router weights stay this forward's own softmax probabilities at the
    forced experts; every pick must fit the capacity (as at cf 2, top-2 of
    4), so none is dropped."""

    def __init__(self, torch, expert_module) -> None:
        self.torch, self.module, self.route = torch, expert_module, expert_module._route
        self.picks, self.force, self.layer, self.hooks = {}, None, None, []
        expert_module._route = self._route

    def watch(self, label: str, model) -> None:
        from pointvit_tpu_torch.nn.moe import MoEMlp

        for name, m in model.named_modules():
            if isinstance(m, MoEMlp):
                self.hooks.append(m.register_forward_pre_hook(
                    lambda *_, key=(label, name): setattr(self, "layer", key)))

    def _route(self, gate_logits, capacity, top_k, normalize_gates, data_group=None):
        if self.force is None:
            out = self.route(gate_logits, capacity, top_k, normalize_gates, data_group)
            self.picks.setdefault(self.layer, out[0].clone())
            return out
        torch = self.torch
        expert = self.picks[(self.force, self.layer[1])]
        if normalize_gates or data_group is not None or capacity < gate_logits.shape[0]:
            fail("forced MoE routing needs plain gates and room for every pick")
        # _route's arithmetic on the given picks (its positions are unused)
        probs = torch.softmax(gate_logits.float(), dim=-1)
        gates = torch.stack([probs.gather(1, idx[:, None])[:, 0] for idx in expert])
        f_e = torch.nn.functional.one_hot(expert[0], probs.shape[-1]).to(probs.dtype).mean(dim=0)
        return expert, gates, None, torch.ones_like(expert, dtype=torch.bool), f_e, probs.mean(dim=0)

    def close(self) -> None:
        self.module._route = self.route
        for h in self.hooks:
            h.remove()


def moe_router_gates(torch, cfg, start, trainable, batch, dev) -> None:
    """The MoE routers' first-step gradients (unclipped, the trainers' loss
    on ``start``'s weights and the first batch) on one routing. The kernel
    path, the plain path and the f32 plain path each route on their own;
    then the plain path and the f32 one run again on the kernel path's
    picks. Prints, for each router, the share of (token, k) picks that
    differ between the runs and the gradients' relative L2 on each run's
    own picks and on the kernel path's; the same for the other tensors
    together and the global norms. Holds each router, on the kernel path's
    picks, to the training gates: within TRAIN_GRAD_REL_TOL of the plain
    path, and at most TRAIN_GRAD_F32_RATIO x the plain path's distance from
    f32."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.parallel import expert as expert_module

    on_k = "on the kernel path's picks"
    probe = RoutingProbe(torch, expert_module)
    g = {}
    try:
        for label, impl, bf16, force in (
                ("kernel", None, True, None), ("plain", "torch", True, None),
                ("f32", "torch", False, None), (f"plain {on_k}", "torch", True, "kernel"),
                (f"f32 {on_k}", "torch", False, "kernel")):
            ref = build_model({**cfg, "bf16": bf16}, implementation=impl)
            probe.watch(label, ref)
            probe.force = force
            g[label] = first_step_grads(torch, ref, start, trainable, batch, 0.0, dev)
            del ref
    finally:
        probe.close()
    pk, pf = g[f"plain {on_k}"], g[f"f32 {on_k}"]
    flat = lambda gs, ns: torch.cat([gs[n].float().flatten() for n in ns])  # noqa: E731
    norms = {k: flat(v, trainable).norm().item() for k, v in g.items()}
    print(f"moe router gates: unclipped global gradient norms {json.dumps(norms)} (the trainers "
          f"clip at {P4P_TRAIN_CONFIG['grad_norm_clip']})", flush=True)
    rest = [n for n in trainable if not n.endswith(".mlp.gate")]
    print(f"moe router gates: the {len(rest)} other tensors together, relative L2: kernel vs plain "
          f"{rel_l2(flat(g['kernel'], rest), flat(g['plain'], rest)):.3g} -> "
          f"{rel_l2(flat(g['kernel'], rest), flat(pk, rest)):.3g} {on_k}, kernel vs f32 "
          f"{rel_l2(flat(g['kernel'], rest), flat(g['f32'], rest)):.3g} -> "
          f"{rel_l2(flat(g['kernel'], rest), flat(pf, rest)):.3g}", flush=True)
    bad = []
    for layer in sorted({name for _, name in probe.picks}):
        differ = lambda a, b: (probe.picks[(a, layer)] != probe.picks[(b, layer)]).float(  # noqa: E731
        ).mean().item()
        n = f"{layer}.gate"
        kp, kf = rel_l2(g["kernel"][n], g["plain"][n]), rel_l2(g["kernel"][n], g["f32"][n])
        kp1, kf1, pf1 = rel_l2(g["kernel"][n], pk[n]), rel_l2(g["kernel"][n], pf[n]), rel_l2(pk[n], pf[n])
        print(f"moe router {n}: (token, k) picks that differ: kernel vs plain "
              f"{differ('kernel', 'plain'):.3%}, kernel vs f32 {differ('kernel', 'f32'):.3%}, plain "
              f"vs f32 {differ('plain', 'f32'):.3%}; first-step gradient relative L2, own picks -> "
              f"{on_k}: kernel vs plain {kp:.3g} -> {kp1:.3g} (bound {TRAIN_GRAD_REL_TOL}), kernel "
              f"vs f32 {kf:.3g} -> {kf1:.3g}, plain vs f32 {rel_l2(g['plain'][n], g['f32'][n]):.3g} "
              f"-> {pf1:.3g} (ratio bound {TRAIN_GRAD_F32_RATIO})", flush=True)
        if not (kp1 <= TRAIN_GRAD_REL_TOL and kf1 <= TRAIN_GRAD_F32_RATIO * pf1):
            bad.append(n)
    if bad:
        fail(f"the MoE routers' gradients of the kernel path disagree on one routing: {bad}")


def moe_phase(torch, dev, _build, smi: str) -> list:
    """(a) of the parallel phase: the MoE Pix4Point trunk (``P4P_CONFIG``
    with ``MOE_KEYS``: blocks 1, 3, …, 11 are MoE blocks of 4 experts,
    top-2, cf 2) at full width and depth, bf16, seeded weights. Serving:
    requests of MOE_REQUESTS clouds of 2048 points on the kernel and the
    plain path (the serving gate), bucket 256 timed. Training: 5 steps of
    64 x 2048 clouds on both paths, built as ``Pix4PointTrainer`` builds its
    optimizer, an f32 first step as the gradient reference (the training
    gates), every router gradient nonzero; a step profiled for the expert
    FFN's share, one block's expert FFN timed alone, and the routers held on
    one routing (``moe_router_gates``). Returns the kernel paths' launch
    counts."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.nn.moe import MoEMlp
    from pointvit_tpu_torch.parallel.expert import _exact_gelu
    from pointvit_tpu_torch.serve import InferenceSession
    from pointvit_tpu_torch.train import Trainer
    from pointvit_tpu_torch.train.pix4point_trainer import pix4point_optimizer

    cfg = {**P4P_CONFIG, "pretrained": False, **MOE_KEYS}
    gen = torch.Generator().manual_seed(SEED + 60)
    model = build_model(cfg)
    randomize(torch, model, gen)
    with torch.no_grad():  # the experts and the router at their fan-in scale
        for m in model.modules():
            if isinstance(m, MoEMlp):
                for name in ("gate", "w1", "w2"):
                    p = getattr(m, name)
                    p.copy_(torch.randn(p.shape, generator=gen) * p.shape[-2] ** -0.5)
    kinds = [type(b).__name__ for b in model.model.blocks]
    if kinds.count("MoEViTBlock") != 6 or kinds[1] != "MoEViTBlock":
        fail(f"the MoE trunk's blocks are {kinds}")
    plain = build_model(cfg, implementation="torch")
    plain.load_state_dict(model.state_dict())
    start = build_model(cfg, implementation="torch")  # the weights before training
    start.load_state_dict(model.state_dict())
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    sess = InferenceSession(model, buckets=MOE_REQUESTS, device=dev)
    psess = InferenceSession(plain, buckets=MOE_REQUESTS, device=dev)
    rng = np.random.default_rng(SEED + 60)
    requests = [rng.standard_normal((n, P4P_POINTS, 3)).astype(np.float32) for n in MOE_REQUESTS]
    sess.warmup(requests[0][0])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    served = [sess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    serve_counts = _build.launch_counts()
    print(f"moe pix4point launches during serving: {json.dumps(serve_counts)}", flush=True)
    serving_gate(f"moe pix4point serving, requests {list(MOE_REQUESTS)}", np.concatenate(served),
                 np.concatenate([psess.predict_logits(r) for r in requests]))
    for name in MOE_SERVE_COUNTERS:
        if serve_counts.get(name, 0) <= 0:
            fail(f"the moe pix4point serving path never launched the {name} kernel")
    big = requests[-1]
    tp1 = cuda_ms(torch, lambda: psess.predict_logits(big), 1)
    tk1 = cuda_ms(torch, lambda: sess.predict_logits(big), 3)
    tk2 = cuda_ms(torch, lambda: sess.predict_logits(big), 3)
    tp2 = cuda_ms(torch, lambda: psess.predict_logits(big), 1)
    print(f"moe pix4point serving at bucket 256 ({smi}): kernel path {(tk1 + tk2) / 2:.3f} "
          f"ms/request (runs {tk1:.3f}, {tk2:.3f}), plain path {(tp1 + tp2) / 2:.3f} ms/request "
          f"(runs {tp1:.3f}, {tp2:.3f})", flush=True)
    busy = device_time_by_kernel(torch, lambda: sess.predict_logits(big), top=12)
    print(f"moe pix4point request at bucket 256 under torch.profiler, kernel path ({smi}): "
          f"{busy['wall_ms']:.3f} ms on the host's clock, {busy['device_ms']:.3f} ms of kernels "
          f"({busy['device_ms'] / busy['wall_ms']:.1%} busy) in {busy['launches']} launches; most "
          f"device time: {json.dumps(busy['top'])}", flush=True)
    del sess, psess
    torch.cuda.empty_cache()

    batch, classes = P4P_TRAIN_CONFIG["batch_size"], cfg["num_classes"]
    models = {"kernel": model, "plain": plain}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
    trainers = {}
    for path, m in models.items():
        sched, opt = pix4point_optimizer(m, P4P_TRAIN_CONFIG, 1)
        trainers[path] = Trainer(m, train_dataset=None, test_dataset=None, optimizer=opt,
                                 schedule=sched, batch_size=batch, epochs=1, label_smoothing=0.0,
                                 output_dir=out_dir, seed=SEED, device=dev, train_loader=[],
                                 test_loader=[], save_config_snapshot=False)
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    batches = []
    for _ in range(MOE_TRAIN_STEPS):
        pts, lbl = shape_clouds(rng, batch, classes, P4P_POINTS)
        batches.append((torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)))
    f32 = first_step_grads(torch, build_model({**cfg, "bf16": False}, implementation="torch"),
                         model, trainable, batches[0], 0.0, dev)
    res = train_paths(torch, _build, trainers, batches, trainable)
    res["grads"]["f32"] = f32
    gates = [n for n in trainable if n.endswith(".mlp.gate")]
    for n in gates:
        gk, gp, gf = (res["grads"][k][n] for k in ("kernel", "plain", "f32"))
        print(f"moe pix4point train: router {n}: kernel vs plain {rel_l2(gk, gp):.3g}, kernel vs "
              f"f32 {rel_l2(gk, gf):.3g}, plain vs f32 {rel_l2(gp, gf):.3g}", flush=True)
    check_training(torch, "moe pix4point train", res, models, init, trainable, P4P_PRE_BN_BIASES,
                   TRAINING_COUNTERS, P4P_TRAIN_UNUSED, apart=gates)
    for path in ("kernel", "plain", "f32"):
        for n in gates:
            if not res["grads"][path][n].abs().max().item() > 0:
                fail(f"moe pix4point train: the {path} path's router gradient {n} is zero")
    print(f"moe pix4point train: {len(gates)} router gradients nonzero on both paths and in f32",
          flush=True)
    print(f"moe pix4point train step at batch {batch} of {P4P_POINTS} points ({smi}): "
          f"{step_line(res, batch)}", flush=True)
    del trainers["plain"], models["plain"], plain
    torch.cuda.empty_cache()
    from torch.profiler import record_function

    from pointvit_tpu_torch.parallel import expert as expert_module

    ffn, widths = expert_module._expert_ffn, []
    ranges = ("moe_expert_ffn_forward", "moe_expert_ffn_backward")

    class RangedFFN(torch.autograd.Function):
        """The expert FFN, its forward and its backward each inside a
        ``record_function`` range; the same kernels."""

        @staticmethod
        def forward(ctx, xin, *weights):
            with torch.enable_grad(), record_function(ranges[0]):
                ctx.ins = [t.detach().requires_grad_(t.requires_grad) for t in (xin, *weights)]
                ctx.out = ffn(*ctx.ins, _exact_gelu)
            return ctx.out.detach()

        @staticmethod
        def backward(ctx, grad):
            with record_function(ranges[1]):
                need = [t for t in ctx.ins if t.requires_grad]
                got = iter(torch.autograd.grad(ctx.out, need, grad))
                return tuple(next(got) if t.requires_grad else None for t in ctx.ins)

    def ranged(xin, w1, b1, w2, b2, activation):
        if activation is not _exact_gelu:
            fail("the MoE trunk's experts do not take the exact GELU")
        widths.append(tuple(xin.shape))
        return RangedFFN.apply(xin, w1, b1, w2, b2)

    expert_module._expert_ffn = ranged
    try:
        busy = device_time_by_kernel(torch, lambda: trainers["kernel"].train_step(*batches[1]),
                                     top=12, ranges=ranges)
    finally:
        expert_module._expert_ffn = ffn
    in_ffn = sum(busy["ranges"].values())
    print(f"moe pix4point train step under torch.profiler (CPU and CUDA), kernel path ({smi}): "
          f"{busy['wall_ms']:.3f} ms on the host's clock, {busy['device_ms']:.3f} ms of kernels "
          f"({busy['device_ms'] / busy['wall_ms']:.1%} busy) in {busy['launches']} launches, "
          f"{busy['linked_ms']:.3f} ms of them linked to a host op; the expert FFN's ranges "
          f"{json.dumps({k: round(v, 3) for k, v in busy['ranges'].items()})} ms, together "
          f"{in_ffn:.3f} ms = {in_ffn / busy['device_ms']:.1%} of the step's kernel time; most "
          f"device time: {json.dumps(busy['top'])}", flush=True)
    print(f"moe pix4point train: expert buffers {widths} (capacity {batch * (P4P_TOKENS + 1)})",
          flush=True)
    # One block's expert FFN alone, at the step's widest buffer: (E, filled
    # slots, M) f32 (the capacity C = T = 64 x 513 tokens; the busiest expert
    # fills fewer).
    mlp = next(m for m in model.modules() if isinstance(m, MoEMlp))
    slots = max(w[1] for w in widths)
    xin = torch.randn(mlp.num_experts, slots, mlp.w1.shape[1], device=dev, requires_grad=True)
    weights = [getattr(mlp, k).detach().to(torch.bfloat16).requires_grad_(True)
               for k in ("w1", "b1", "w2", "b2")]
    cot = torch.randn(mlp.num_experts, slots, mlp.w1.shape[1], device=dev)

    def ffn_step():
        y = ffn(xin, *weights, _exact_gelu)
        torch.autograd.backward(y, cot)

    ffn_ms = cuda_ms(torch, ffn_step, 3)
    fwd_ms = cuda_ms(torch, lambda: ffn(xin, *weights, _exact_gelu), 3)
    print(f"moe expert FFN of one block alone ({smi}): ({mlp.num_experts}, {slots}, "
          f"{mlp.w1.shape[1]}) f32 slots, forward {fwd_ms:.3f} ms, forward + backward "
          f"{ffn_ms:.3f} ms", flush=True)
    del trainers, models, model, xin, weights, cot
    torch.cuda.empty_cache()
    moe_router_gates(torch, cfg, start, trainable, batches[0], dev)
    shutil.rmtree(out_dir)
    torch.cuda.empty_cache()
    return [serve_counts, res["counts"]]


def world1_phase(torch, dev, _build, smi: str) -> list:
    """(b) of the parallel phase: a world-1 NCCL process group (a FileStore
    in a temporary directory). APF slim2 at full width and depth trains
    PARALLEL_STEPS steps of 64 x 1024 clouds with ``Trainer()``,
    ``Trainer(mesh=make_mesh())`` (DDP) and ``Trainer(mesh=..., fsdp=True)``
    (FSDP2) from the same seed: DDP and FSDP each bit for bit against
    ``Trainer()``, or within 1e-6 relative after the last step (the case
    printed). The FSDP trainer's
    checkpoint serves in a session with no mesh; ``InferenceSession(mesh=)``
    serves requests 1/32/256 against a session without one;
    ``batch_shard_map`` over the attention (row 5) and group encoder (row 3)
    wrappers against direct calls. Returns the launch counts of its runs."""
    import os

    import torch.distributed as dist

    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config, apf_trainable_mask
    from pointvit_tpu_torch.ops import encoder_kernel
    from pointvit_tpu_torch.ops.attention_kernel import fused_mha_qkv
    from pointvit_tpu_torch.ops.group import apf_group
    from pointvit_tpu_torch.parallel import batch_shard_map, make_mesh
    from pointvit_tpu_torch.serve import InferenceSession
    from pointvit_tpu_torch.train import Trainer, build_optimizer, timm_cosine_schedule

    tmp = tempfile.mkdtemp(prefix="chip_smoke_world1_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        cfg = apf_preset_config("slim2", num_classes=TRAIN_CLASSES)
        gen = torch.Generator().manual_seed(SEED + 70)
        base = AdaptPointFormer(**cfg)
        randomize(torch, base, gen)
        rng = np.random.default_rng(SEED + 70)
        batches = []
        for _ in range(PARALLEL_STEPS):
            pts, lbl = shape_clouds(rng, PARALLEL_BATCH, TRAIN_CLASSES)
            batches.append((torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)))
        counts = []
        trained = {}
        full = lambda v: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach().clone()  # noqa: E731
        for layout, kw in (("one process", {}), ("DDP", {"mesh": mesh}),
                           ("FSDP", {"mesh": mesh, "fsdp": True})):
            model = AdaptPointFormer(**cfg)
            model.load_state_dict(base.state_dict())
            sched = timm_cosine_schedule(LR, 100, 1, warmup_epochs=5, warmup_lr_init=1e-3)
            opt = build_optimizer(model, sched, weight_decay=WEIGHT_DECAY,
                                  trainable_mask=apf_trainable_mask(model), grad_clip=1.0)
            tr = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, schedule=sched,
                         batch_size=PARALLEL_BATCH, epochs=1, label_smoothing=LABEL_SMOOTHING,
                         output_dir=os.path.join(tmp, layout), seed=SEED, device=dev,
                         train_loader=[], test_loader=[], save_config_snapshot=False, **kw)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            losses = [tr.train_step(*batches[0])[0].item()]  # the first step allocates
            first = {k: full(v) for k, v in model.state_dict().items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += [tr.train_step(*b)[0].item() for b in batches[1:]]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts.append(_build.launch_counts())
            for name in TRAINING_COUNTERS:
                if counts[-1].get(name, 0) <= 0:
                    fail(f"world-1 {layout} training never launched the {name} kernel")
            trained[layout] = (losses, first, {k: full(v) for k, v in model.state_dict().items()})
            print(f"world-1 {layout}: {PARALLEL_STEPS} steps of {PARALLEL_BATCH} x {POINTS} clouds, "
                  f"losses {losses}, {secs * 1e3 / (PARALLEL_STEPS - 1):.1f} ms/step on the host's "
                  f"clock after the first ({smi})", flush=True)
            if layout == "FSDP":
                path = tr._save_checkpoint("fsdp.pt", 0, 0.5)
            del tr, opt

        def held(layout):
            """Bit for bit against the one-process run, else the worst
            relative error of a weight after the first and the last step."""
            (l1, f1, s1), (l0, f0, s0) = trained[layout], trained["one process"]
            same = l1 == l0 and all(torch.equal(s1[k], t) for k, t in s0.items())
            worst = lambda a, b: max(rel_err(torch, a[k], t)[1]  # noqa: E731
                                     for k, t in b.items() if t.is_floating_point())
            first, last = worst(f1, f0), worst(s1, s0)
            case = "bit-equal" if same else f"not bit-equal, worst weight within {last:.3g} relative"
            print(f"world-1 {layout} vs one process after {PARALLEL_STEPS} steps: {case} (after "
                  f"the first step {first:.3g}; losses {l1} vs {l0})", flush=True)
            return same or last <= 1e-6

        # At one rank the collectives are copies and every layout runs the
        # one-process arithmetic (torch's multi-tensor AdamW, the same clip).
        for layout in ("DDP", "FSDP"):
            if not held(layout):
                fail(f"world-1 {layout} training drifted from the one-process trainer")

        served = AdaptPointFormer(**cfg)
        served.load_state_dict(trained["FSDP"][2])
        want_sess = InferenceSession(served, device=dev)
        ck = InferenceSession.from_checkpoint(path, model=AdaptPointFormer(**cfg), device=dev)
        msess = InferenceSession(served, device=dev, mesh=mesh)
        reqs = [rng.standard_normal((n, POINTS, 3)).astype(np.float32) for n in (1, 32, 256)]
        _build.reset_launch_counts()
        for r in reqs:
            want = want_sess.predict_logits(r)
            for label, sess in (("the FSDP checkpoint, no mesh", ck), ("a session with a mesh", msess)):
                got = sess.predict_logits(r)
                if not np.array_equal(got, want):
                    serving_gate(f"world-1 {label}, request of {len(r)}", got, want)
                print(f"world-1 {label}, request of {len(r)}: bit-equal {np.array_equal(got, want)}",
                      flush=True)
        torch.cuda.synchronize()
        counts.append(_build.launch_counts())
        if msess.buckets != want_sess.buckets:
            fail(f"a world-1 mesh changed the buckets: {msess.buckets}")

        qkv = torch.randn(256, 197, 2304, device=dev, dtype=torch.bfloat16, generator=torch.Generator(
            device=dev).manual_seed(SEED + 71))
        pts = torch.from_numpy(reqs[-1][:PARALLEL_BATCH]).to(dev)
        neigh, _ = apf_group(pts, pts, cfg["npoint"], cfg["nsample"])
        groups = neigh.to(torch.bfloat16).reshape(-1, cfg["nsample"], neigh.shape[-1]).contiguous()
        w_enc = encoder_kernel.fold_encoder_params(served.point_encoder)
        _build.reset_launch_counts()
        for label, fn, x in (("mha_qkv", lambda t: fused_mha_qkv(t, 12), qkv),
                             ("group_encoder", lambda t: encoder_kernel.fused_group_encoder(t, w_enc),
                              groups)):
            got = batch_shard_map(fn, mesh)(x)
            want = fn(x)
            torch.cuda.synchronize()
            d, r = rel_err(torch, got, want)
            print(f"world-1 batch_shard_map over {label} {tuple(x.shape)}: bit-equal "
                  f"{torch.equal(got, want)}, max|d| {d:.3g}", flush=True)
            if not torch.equal(got, want):
                fail(f"batch_shard_map over {label} at world 1 is not the direct call")
        torch.cuda.synchronize()
        counts.append(_build.launch_counts())
        for name in ("mha_qkv", "group_encoder"):
            if counts[-1].get(name, 0) <= 0:
                fail(f"batch_shard_map never launched the {name} kernel")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def parallel_phase(torch, dev, _build, smi: str) -> list:
    t0 = time.perf_counter()
    counts = moe_phase(torch, dev, _build, smi)
    t1 = time.perf_counter()
    counts += world1_phase(torch, dev, _build, smi)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s (moe {t1 - t0:.1f} s, world-1 "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)
    launched = {n for c in counts for n, v in c.items() if v > 0}
    for name in ("fps", "knn", "mha_qkv", "mha_qkv_bwd", "p3_embed", "vit_block"):
        if name not in launched:
            fail(f"the parallel phase never launched {name}")
    return counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA card")
    try:
        from pointvit_tpu_torch import _build
        from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config
        from pointvit_tpu_torch.nn.layers import layer_norm, linear
        from pointvit_tpu_torch.ops import (
            attention_kernel, block_kernel, encoder_kernel, fps_kernel, knn_kernel, p3_kernel,
            quant_kernel, serial_block_kernel, vit_block_kernel,
        )
        from pointvit_tpu_torch.ops import gemm_kernel
        from pointvit_tpu_torch.ops.gemm_kernel import gemm
        from pointvit_tpu_torch.ops.fps import fps_gather
        from pointvit_tpu_torch.ops.group import apf_group, p3_group
        from pointvit_tpu_torch.serve import InferenceSession
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- build -------------------------------------------------------------
    print(f"build: {_build.build_kernels():.1f} s", flush=True)

    # -- the main path: serving slim2 at full width --------------------------
    cfg = apf_preset_config("slim2")
    gen = torch.Generator().manual_seed(SEED)
    model = AdaptPointFormer(**cfg)
    randomize(torch, model, gen)
    plain = AdaptPointFormer(**cfg, implementation="torch")
    plain.load_state_dict(model.state_dict())
    sess = InferenceSession(model, device=dev)
    psess = InferenceSession(plain, device=dev)
    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((n, POINTS, 3)).astype(np.float32) for n in REQUESTS]
    sess.warmup(requests[0][0])
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    served = [sess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"launches during serving: {json.dumps(counts)}", flush=True)

    want = [psess.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    got_all, want_all = np.concatenate(served), np.concatenate(want)
    if got_all.shape != (sum(REQUESTS), cfg["num_classes"]) or not np.isfinite(got_all).all():
        fail(f"served logits: shape {got_all.shape}, finite {np.isfinite(got_all).all()}")
    agree = float((got_all.argmax(-1) == want_all.argmax(-1)).mean())
    dlogit = float(np.abs(got_all - want_all).max())
    scale = float(np.abs(want_all).max())
    print(f"serving: requests {list(REQUESTS)}: argmax agreement {agree:.4f} "
          f"(need >= {ARGMAX_AGREEMENT}), max|dlogit| {dlogit:.6g} vs max|logit| {scale:.6g} "
          f"(bound {LOGIT_REL_TOL} x max|logit|)", flush=True)
    if agree < ARGMAX_AGREEMENT or dlogit > LOGIT_REL_TOL * scale:
        fail("kernel-path logits disagree with the plain path")
    for name in SERVING_COUNTERS:
        if counts.get(name, 0) <= 0:
            fail(f"the serving path never launched the {name} kernel")
    if counts.get("group_encoder_chain", 0):
        fail("the bf16 serving path ran the encoder's GEMM chain, not its group-MLP kernels")

    big = requests[-1]
    run_k = lambda: sess.predict_logits(big)
    run_p = lambda: psess.predict_logits(big)
    tp1 = cuda_ms(torch, run_p, 2)
    tk1 = cuda_ms(torch, run_k, 5)
    tk2 = cuda_ms(torch, run_k, 5)
    tp2 = cuda_ms(torch, run_p, 2)
    tk, tp = (tk1 + tk2) / 2, (tp1 + tp2) / 2
    print(f"serving throughput at bucket 256: kernel path {256e3 / tk:.1f} clouds/s "
          f"({tk:.3f} ms/request; runs {tk1:.3f}, {tk2:.3f}), plain path {256e3 / tp:.1f} "
          f"clouds/s ({tp:.3f} ms/request; runs {tp1:.3f}, {tp2:.3f})", flush=True)

    # -- checkpoints, export and HTTP: serving_io at full width and depth -----
    io_counts = serving_io_phase(torch, dev, _build, model, sess, requests, served)

    # -- weights and state from outside: hub files, training from them, the
    # -- reference's checkpoints (APF exact), resuming a JAX-format run --------
    ingest_counts = ingest_phase(torch, dev, _build, smi)

    # -- parallelism: the MoE Pix4Point trunk, then DDP/FSDP/serving/shard_map
    # -- on a world-1 NCCL group -----------------------------------------------
    parallel_counts = parallel_phase(torch, dev, _build, smi)

    # -- the fifth path: quantized (w8a8) slim2 serving on the same weights ---
    t_quant = time.perf_counter()
    quant = quant_phase(torch, dev, _build, model, requests, got_all, tk)
    print(f"quantized phase: {time.perf_counter() - t_quant:.1f} s", flush=True)

    # -- the second path: training slim2 at full width -----------------------
    t_train = time.perf_counter()
    train_counts = train_phase(torch, dev, _build)["counts"]
    print(f"training phase: {time.perf_counter() - t_train:.1f} s", flush=True)

    # -- training above the JAX Pallas gate: one slim2 step at npoint 1536 ---
    t_train = time.perf_counter()
    train_long_counts = train_long_phase(torch, dev, _build)["counts"]
    print(f"npoint {LONGER_NPOINT} training phase: {time.perf_counter() - t_train:.1f} s", flush=True)

    # -- Pix4Point (vit_small) training at full width, batch 64 x 2048 -------
    t_train = time.perf_counter()
    p4p_train_counts = pix4point_train_phase(torch, dev, _build)["counts"]
    print(f"pix4point training phase: {time.perf_counter() - t_train:.1f} s", flush=True)

    # -- renderer (vit_b_16, 6 learned views) training, batch 16 x 2048 ------
    t_train = time.perf_counter()
    rend_train_counts = renderer_train_phase(torch, dev, _build)["counts"]
    print(f"renderer training phase: {time.perf_counter() - t_train:.1f} s", flush=True)

    # -- the third path: Pix4Point (vit_small) serving at full width ---------
    t_p4p = time.perf_counter()
    p4p = pix4point_phase(torch, dev, _build)
    print(f"pix4point phase: {time.perf_counter() - t_p4p:.1f} s", flush=True)

    # -- Pix4Point off the P3 kernel's shapes: 1000 and 1004 points ----------
    t_off = time.perf_counter()
    p4p_off_counts = p3_off_shape_phase(torch, dev, _build, p4p["model"])
    print(f"pix4point off-shape phase: {time.perf_counter() - t_off:.1f} s", flush=True)

    # -- the fourth path: renderer (vit_b_16, 6 learned views) serving -------
    t_rend = time.perf_counter()
    rend = renderer_phase(torch, dev, _build)
    print(f"renderer phase: {time.perf_counter() - t_rend:.1f} s", flush=True)

    # -- f32 models: APF slim2 and Pix4Point vit_small, bf16=False -----------
    from pointvit_tpu_torch.models import build_model

    t_f32 = time.perf_counter()
    apf32 = f32_serving_phase(
        torch, dev, _build, "APF slim2",
        lambda impl: AdaptPointFormer(**apf_preset_config("slim2", dtype=torch.float32),
                                      implementation=impl),
        model.state_dict(), POINTS, SEED + 21,
        ("fps", "knn", "group_encoder_chain", "apf_block", "gemm_f32", "layernorm", "attention_any"))
    p4p32 = f32_serving_phase(
        torch, dev, _build, "Pix4Point vit_small",
        lambda impl: build_model({**P4P_CONFIG, "bf16": False}, implementation=impl),
        p4p["model"].state_dict(), P4P_POINTS, SEED + 22,
        ("fps", "knn", "p3_embed_chain", "vit_block", "gemm_f32", "layernorm", "pos_layernorm", "attention_any"))
    print(f"f32 phase: {time.perf_counter() - t_f32:.1f} s", flush=True)

    # -- a head dim 16 model: serving and training (f32) ---------------------
    t_small = time.perf_counter()
    small = small_model_phase(torch, dev, _build)
    print(f"head dim 16 phase: {time.perf_counter() - t_small:.1f} s", flush=True)

    # -- csrc/attention_any.cu at head dims 8, 16, 32, 128 -------------------
    t_any = time.perf_counter()
    attention_any_phase(torch, dev)
    print(f"attention_any phase: {time.perf_counter() - t_any:.1f} s", flush=True)

    # -- each kernel against its plain version, at main-path shapes ----------
    def fps_phase(pts, S):
        st = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
        got, want = fps_kernel.fps(pts, S, st), fps_kernel.reference_fps(pts, S, st)
        again = fps_kernel.fps(pts, S, st)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps: {(got != want).sum().item()} indices differ")
        if not torch.equal(got, again):
            fail(f"fps: two runs differ in {(got != again).sum().item()} indices")
        Bp, Np, _ = pts.shape
        res = dict(shape=f"({Bp}, {Np}, 3) -> {S}", max_abs_err=0.0,
                   ms=cuda_ms(torch, lambda: fps_kernel.fps(pts, S, st), 10),
                   plain_ms=cuda_ms(torch, lambda: fps_kernel.reference_fps(pts, S, st), 3),
                   # A distance (3 sub, 3 mul, 2 add), a min and a compare per point and
                   # step: no FMA (the bit rule forbids contraction), so they issue at the
                   # f32 rate of one operation an instruction, half of PEAK_F32 (which
                   # counts an FMA as two).
                   **bound(10.0 * Bp * S * Np, nbytes(pts, st, got), PEAK_F32 / 2), library_ms=None)
        _, threads, per_thread = fps_kernel.launch_shape(Np)
        print(f"fps {res['shape']}: indices equal to the plain version's and across two runs; "
              f"{threads} threads of {per_thread} points a cloud; kernel {res['ms']:.4f} ms, "
              f"{res['ms'] / S * 1e3:.3f} us a step; bound {res['bound_ms']:.4f} ms (ops); plain "
              f"{res['plain_ms']:.4f} ms", flush=True)
        return got, res

    def knn_phase(pts, centers, feats, k, instance=None):
        ki, kf = knn_kernel.knn_group(pts, centers, feats, k, instance)
        pi, pf = knn_kernel.reference_knn_group(pts, centers, feats, k)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            fail(f"knn: {(ki != pi).sum().item()} indices differ")
        if not torch.equal(kf, pf):
            fail("knn: gathered features are not bit-equal")
        Bp, Np, _ = pts.shape
        S = centers.shape[1]
        res = dict(shape=f"N={Np}, S={S}, k={k}, C={feats.shape[-1]}, B={Bp}", max_abs_err=0.0,
                   ms=cuda_ms(torch, lambda: knn_kernel.knn_group(pts, centers, feats, k, instance), 10),
                   plain_ms=cuda_ms(torch, lambda: knn_kernel.reference_knn_group(pts, centers, feats, k), 3),
                   # the function's own work per (centre, point): a distance (3 sub,
                   # 3 mul, 2 add) and one compare against the running k-th key
                   **bound(9.0 * Bp * S * Np, nbytes(pts, centers, feats, ki, kf), PEAK_F32),
                   library_ms=None)
        print(f"knn {res['shape']} ({instance or knn_kernel.knn_instance(k)} instance): indices equal, "
              f"features bit-equal", flush=True)
        return res

    def held(name, got, want, shape):
        torch.cuda.synchronize()
        d, r = rel_err(torch, got, want)
        print(f"{name} {shape}: max|d| {d:.6g}, relative to max|ref| {r:.3g} "
              f"(bound {BF16_REL_TOL:.3g})", flush=True)
        if not r <= BF16_REL_TOL:
            fail(f"{name} disagrees with its plain version")
        return d

    results, apf_shapes, more_shapes = {}, {}, {}
    with torch.inference_mode():
        # FPS and kNN at the APF shape (printed), then at Pix4Point's (the line).
        xyz = torch.from_numpy(big).to(dev)
        B, G, K = xyz.shape[0], cfg["npoint"], cfg["nsample"]
        idx_k, apf_shapes["fps"] = fps_phase(xyz, G)
        center = fps_gather(xyz, idx_k).contiguous()
        # requests of 1 and 5 clouds, and APF at npoint 1536 (8 clouds of 4096 points)
        for n in REQUESTS[:2]:
            _, more_shapes[f"fps {n} clouds"] = fps_phase(xyz[:n].contiguous(), G)
        wide = torch.from_numpy(np.random.default_rng(SEED + 30).standard_normal(
            (LONGER_BATCH, LONGER_POINTS, 3)).astype(np.float32)).to(dev)
        _, more_shapes["fps npoint 1536"] = fps_phase(wide, LONGER_NPOINT)
        del wide
        apf_shapes["knn"] = knn_phase(xyz, center, xyz, K)
        pts = p4p["points"]
        p_idx, results["fps"] = fps_phase(pts, P4P_TOKENS)
        p_ctr = fps_gather(pts, p_idx).contiguous()
        p_feats = torch.cat([pts, pts], -1).contiguous()
        results["knn"] = knn_phase(pts, p_ctr, p_feats, 16)
        # k 32 (the presets' other k), and the rows instance at the list's shapes
        apf_shapes["knn k 32"] = knn_phase(xyz, center, xyz, 32)
        apf_shapes["knn rows"] = knn_phase(xyz, center, xyz, K, "rows")
        more_shapes["knn k 32"] = knn_phase(pts, p_ctr, p_feats, 32)
        more_shapes["knn rows"] = knn_phase(pts, p_ctr, p_feats, 16, "rows")
        results["knn_rows"] = knn_phase(pts, p_ctr, p_feats, KNN_WIDE_K)
        knn_wide_counts = knn_wide_phase(torch, _build, pts)

        neigh, _ = apf_group(xyz, xyz, G, K)
        x_enc = neigh.to(torch.bfloat16).reshape(B * G, K, -1).contiguous()
        w_enc = encoder_kernel.fold_encoder_params(model.point_encoder)
        ek = encoder_kernel.fused_group_encoder(x_enc, w_enc)
        d = held("group_encoder", ek, encoder_kernel.reference_folded_encoder(x_enc, w_enc),
                 f"{tuple(x_enc.shape)} -> {tuple(ek.shape)}")
        w0, _, w1, _, w2, _, wg, wl, _, w3, _ = w_enc
        flops = 2.0 * B * G * (K * sum(w.numel() for w in (w0, w1, w2, wl, w3)) + wg.numel())
        results["group_encoder"] = dict(
            shape=str(tuple(x_enc.shape)), max_abs_err=d,
            ms=cuda_ms(torch, lambda: encoder_kernel.fused_group_encoder(x_enc, w_enc), 5),
            plain_ms=cuda_ms(torch, lambda: encoder_kernel.reference_folded_encoder(x_enc, w_enc), 2),
            **bound(flops, nbytes(x_enc, ek) + 2 * sum(w.numel() for w in w_enc)), library_ms=None)
        group_mlp_ab(torch, "group_encoder", encoder_kernel, x_enc, w_enc, flops)
        nsample_phase(torch, _build, encoder_kernel, apf_group, xyz, G, w_enc)

        tokens = ek.reshape(B, G, -1)
        blk = model.blocks[0]
        w_blk = block_kernel.apf_block_weights(blk)
        heads = blk.num_heads
        bk = block_kernel.fused_apf_block(tokens, w_blk, heads)
        d = held("apf_block", bk, block_kernel.reference_apf_block(tokens, w_blk, heads),
                 f"{tuple(tokens.shape)} heads {heads}")
        E = tokens.shape[-1]
        mats = sum(w.numel() for w in w_blk if w.dim() == 2)
        results["apf_block"] = dict(
            shape=f"{tuple(tokens.shape)}, {heads} heads", max_abs_err=d,
            ms=cuda_ms(torch, lambda: block_kernel.fused_apf_block(tokens, w_blk, heads), 5),
            plain_ms=cuda_ms(torch, lambda: block_kernel.reference_apf_block(tokens, w_blk, heads), 2),
            **bound(2.0 * B * G * mats + 4.0 * B * G * G * E,
                    2 * nbytes(tokens) + 2 * sum(w.numel() for w in w_blk)), library_ms=None)

        # The training path's attention: qkv as block 0 makes it from real
        # tokens, a seeded bf16 cotangent for the backward.
        ln_apf = layer_norm(tokens, blk.norm1)  # also fused_attention_block's input below
        qkv = linear(ln_apf, blk.attention.qkv).contiguous()
        ak = attention_kernel.mha_qkv(qkv, heads)
        d = held("mha_qkv", ak, attention_kernel.reference_mha_qkv(qkv, heads),
                 f"{tuple(qkv.shape)} heads {heads}")
        results["mha_qkv"] = dict(
            shape=f"{tuple(qkv.shape)}, {heads} heads", max_abs_err=d,
            ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv(qkv, heads), 10),
            plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv(qkv, heads), 3),
            **bound(4.0 * B * G * G * E, nbytes(qkv, ak)))

        # Pix4Point: the P3 stage and block 0 on the data the model makes.
        vit = p4p["model"].model
        pe = vit.patch_embed
        p_ctr, gp, gf = p3_group(pts, pts, P4P_TOKENS, pe.k)
        x_p3 = torch.cat([gp, gf], -1).to(torch.bfloat16)
        Bp, S, Kp, C = x_p3.shape
        x_p3 = x_p3.reshape(Bp * S, Kp, C).contiguous()
        w_p3 = p3_kernel.fold_p3_stage_params(pe, 0)
        pk = p3_kernel.fused_p3_embed(x_p3, w_p3)
        d = held("p3_embed", pk, p3_kernel.reference_folded_p3(x_p3, w_p3),
                 f"{tuple(x_p3.shape)} -> {tuple(pk.shape)}")
        w01, _, w2g, w2l, _, w3, _ = w_p3
        flops = 2.0 * Bp * S * (Kp * (C * w01.shape[1] + w2l.numel() + w3.numel()) + w2g.numel())
        results["p3_embed"] = dict(
            shape=str(tuple(x_p3.shape)), max_abs_err=d,
            ms=cuda_ms(torch, lambda: p3_kernel.fused_p3_embed(x_p3, w_p3), 5),
            plain_ms=cuda_ms(torch, lambda: p3_kernel.reference_folded_p3(x_p3, w_p3), 2),
            **bound(flops, nbytes(x_p3, pk) + 2 * sum(w.numel() for w in w_p3)), library_ms=None)
        group_mlp_ab(torch, "p3_embed", p3_kernel, x_p3, w_p3, flops)

        x0 = linear(pk.reshape(Bp, S, -1), vit.proj)
        pos0 = vit.pos_embed(p_ctr)
        Ep = x0.shape[-1]
        x0 = torch.cat([vit.cls_token.expand(Bp, 1, Ep).to(x0.dtype), x0], 1).contiguous()
        pos0 = torch.cat([vit.cls_pos.expand(Bp, 1, Ep).to(pos0.dtype), pos0], 1).contiguous()
        vblk = vit.blocks[0]
        w_vit = vit_block_kernel.vit_block_weights(vblk, torch.bfloat16)
        vh = vblk.num_heads
        vk = vit_block_kernel.fused_vit_block(x0, w_vit, vh, pos0)
        d = held("vit_block", vk, vit_block_kernel.reference_vit_block(x0, w_vit, vh, pos0),
                 f"{tuple(x0.shape)} heads {vh}, pos per cloud")
        Sp = S + 1
        mats = sum(w.numel() for w in w_vit if w.dim() == 2)
        results["vit_block"] = dict(
            shape=f"{tuple(x0.shape)}, {vh} heads, pos per cloud", max_abs_err=d,
            ms=cuda_ms(torch, lambda: vit_block_kernel.fused_vit_block(x0, w_vit, vh, pos0), 5),
            plain_ms=cuda_ms(torch, lambda: vit_block_kernel.reference_vit_block(x0, w_vit, vh, pos0), 2),
            **bound(2.0 * Bp * Sp * mats + 4.0 * Bp * Sp * Sp * Ep,
                    nbytes(x0, pos0, vk, *w_vit)), library_ms=None)
        results["proj_layernorm"] = vit_split(torch, x0, w_vit, vh, pos0)["line"]
        vit_gemms = gemm_phase(torch, "ViT block", VIT_GEMMS, record_gemms(
            vit_block_kernel, lambda: vit_block_kernel.fused_vit_block(x0, w_vit, vh, pos0)))
        fc2 = vit_gemms[VIT_GEMMS.index("fc2")]
        if fc2["instance"] != "pingpong":
            fail(f"the ViT fc2 took the {fc2['instance']} instance, not the ping-pong one")
        results["gemm_pingpong"] = dict(
            shape=f"ViT fc2 {fc2['shape']}, bf16 residual", max_abs_err=fc2["max_abs_err"],
            **{k: fc2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        del vit_gemms

        # The S=513 attention inside that block, alone.
        ln_p4p = layer_norm(x0 + pos0, vblk.norm1)
        qkv5 = linear(ln_p4p, vblk.attn.qkv).contiguous()
        a5 = block_kernel.attention(qkv5, vh)
        d = held("attention S=513", a5, block_kernel.reference_attention(qkv5, vh),
                 f"{tuple(qkv5.shape)} heads {vh}")
        att513 = dict(
            max_abs_err=d, ms=cuda_ms(torch, lambda: block_kernel.attention(qkv5, vh), 10),
            plain_ms=cuda_ms(torch, lambda: block_kernel.reference_attention(qkv5, vh), 3),
            **bound(4.0 * Bp * Sp * Sp * Ep, nbytes(qkv5, a5)))

        # The renderer: block 0 on the tokens the served model gave it.
        x0 = rend["x0"]
        rblk = rend["model"].vit.encoder_layer[0]
        w_ser = serial_block_kernel.serial_block_weights(rblk, torch.bfloat16)
        rh = rblk.num_heads
        sk = serial_block_kernel.fused_serial_block(x0, w_ser, rh)
        d = held("serial_block", sk, serial_block_kernel.reference_serial_block(x0, w_ser, rh),
                 f"{tuple(x0.shape)} heads {rh}")
        Br, Sr, Er = x0.shape
        mats = sum(w.numel() for w in w_ser if w.dim() == 2)
        results["serial_block"] = dict(
            shape=f"{tuple(x0.shape)}, {rh} heads, bottleneck {w_ser[6].shape[0]}", max_abs_err=d,
            ms=cuda_ms(torch, lambda: serial_block_kernel.fused_serial_block(x0, w_ser, rh), 3),
            plain_ms=cuda_ms(torch, lambda: serial_block_kernel.reference_serial_block(x0, w_ser, rh),
                             1),
            **bound(2.0 * Br * Sr * mats + 4.0 * Br * Sr * Sr * Er, nbytes(x0, sk, *w_ser)),
            library_ms=None)
        del sk

        # The GEMM at each distinct product of the serial and APF block
        # chains and the group encoder, on the inputs block 0 (and the
        # encoder) of the served models gave it.
        t_gemm = time.perf_counter()
        gemm_rows = {
            "serial block": gemm_phase(torch, "serial block", SERIAL_GEMMS, record_gemms(
                serial_block_kernel, lambda: serial_block_kernel.fused_serial_block(x0, w_ser, rh))),
            "APF block": gemm_phase(torch, "APF block", APF_GEMMS, record_gemms(
                block_kernel, lambda: block_kernel.fused_apf_block(tokens, w_blk, heads))),
            "group encoder": gemm_phase(torch, "group encoder", ENCODER_GEMMS, record_gemms(
                encoder_kernel, lambda: encoder_kernel.launch_chain(x_enc, w_enc))),
            "P3 stage": gemm_phase(torch, "P3 stage", P3_GEMMS, record_gemms(
                p3_kernel, lambda: p3_kernel.launch_chain(x_p3, w_p3))),
        }
        torch.cuda.synchronize()
        print(f"gemm phase: {time.perf_counter() - t_gemm:.1f} s", flush=True)

        # The S=197 attention inside that block, alone.
        ln_rend = layer_norm(x0, rblk.ln_1)
        qkv197 = linear(ln_rend, rblk.self_attention.qkv).contiguous()
        a197 = block_kernel.attention(qkv197, rh)
        d = held("attention S=197", a197, block_kernel.reference_attention(qkv197, rh),
                 f"{tuple(qkv197.shape)} heads {rh}")
        att197 = dict(
            max_abs_err=d, ms=cuda_ms(torch, lambda: block_kernel.attention(qkv197, rh), 5),
            plain_ms=cuda_ms(torch, lambda: block_kernel.reference_attention(qkv197, rh), 1),
            **bound(4.0 * Br * Sr * Sr * Er, nbytes(qkv197, a197)))

        # Quantized serving: the int8 dense at its eight layers' shapes, on
        # the inputs the served model gave them; bit-equal or fail.
        qlayers = dict(quant["model"].named_modules())
        quant_shapes = {}
        for name in QUANT_LAYERS:
            lin = qlayers[name]
            wq, sw = lin.quantized_weight()
            qb = lin.bias.detach() if lin.bias is not None else None
            xl = quant["inputs"].pop(name)
            xl = xl.reshape(-1, xl.shape[-1])
            qk = quant_kernel.quant_dense(xl, wq, sw, qb)
            qp = quant_kernel.reference_quant_dense(xl, wq, sw, qb)
            torch.cuda.synchronize()
            if not torch.equal(qk.view(torch.int16), qp.view(torch.int16)):
                fail(f"quant_dense {name}: {(qk.view(torch.int16) != qp.view(torch.int16)).sum().item()}"
                     f" outputs differ from the plain version")
            del qp
            Mq, Kq = xl.shape
            Nq = wq.shape[0]
            xq, _ = quant_kernel.quantize_rows(xl)
            wt = wq.t()
            w16 = lin.weight.detach().to(torch.bfloat16)
            b16 = qb.to(torch.bfloat16) if qb is not None else None
            quant_shapes[name] = dict(
                shape=f"({Mq}, {Kq}) -> {Nq}", max_abs_err=0.0,
                ms=cuda_ms(torch, lambda: quant_kernel.quant_dense(xl, wq, sw, qb), 10),
                quantizer_ms=cuda_ms(torch, lambda: quant_kernel.launch_quantize_rows(xl), 10),
                ops=2.0 * Mq * Nq * Kq,
                plain_ms=cuda_ms(torch, lambda: quant_kernel.reference_quant_dense(xl, wq, sw, qb), 2),
                **bound(2.0 * Mq * Nq * Kq, nbytes(xl, wq, sw, qk) + (nbytes(qb) if qb is not None else 0),
                        PEAK_INT8),
                library_ms=cuda_ms(torch, lambda: torch._int_mm(xq, wt), 10),
                gemm_ms=cuda_ms(torch, lambda: gemm(xl, w16, b16), 10))
            print(f"quant_dense {name} {quant_shapes[name]['shape']}: bit-equal to its plain version",
                  flush=True)
            del xl, qk, xq
        results["quant_dense"] = {k: v for k, v in quant_shapes[QUANT_LINE_LAYER].items()
                                  if k not in ("gemm_ms", "quantizer_ms", "ops")}
    torch.cuda.synchronize()

    # One PyTorch call computing the same function, timed only (the port
    # never calls it): SDPA on the heads split out of the packed qkv.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = heads_of(qkv, heads)
    results["mha_qkv"]["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, v), 10)
    q5, k5, v5 = heads_of(qkv5, vh)
    att513["library_ms"] = cuda_ms(torch, lambda: sdpa(q5, k5, v5), 10)
    q197, k197, v197 = heads_of(qkv197, rh)
    att197["library_ms"] = cuda_ms(torch, lambda: sdpa(q197, k197, v197), 5)
    del q197, k197, v197, q, k, v
    torch.cuda.synchronize()

    # -- the attention backward at the three served models' attention shapes
    t_bwd = time.perf_counter()
    bwd = {"APF": attention_bwd_phase(torch, "APF", qkv, heads, SEED + 2, iters=10, plain_iters=3),
           "S=197": attention_bwd_phase(torch, "S=197", qkv197, rh, SEED + 11),
           "S=513": attention_bwd_phase(torch, "S=513", qkv5, vh, SEED + 12)}
    results["mha_qkv_bwd"] = {k: v for k, v in bwd["APF"].items() if k != "flops"}
    print(f"attention backward phase: {time.perf_counter() - t_bwd:.1f} s", flush=True)

    # -- the sixth path: fused_attention_block forward and backward at the
    #    attention sublayers of the three served models ---------------------
    t_ab = time.perf_counter()
    ab_counts, ab = attn_block_phase(torch, dev, _build, [
        ("APF", ln_apf, attention_kernel.attention_block_weights(blk.attention), heads),
        ("Pix4Point", ln_p4p, attention_kernel.attention_block_weights(vblk.attn), vh),
        ("renderer", ln_rend, attention_kernel.attention_block_weights(rblk.self_attention), rh)])
    results["attn_block"] = {k: v for k, v in ab["APF"].items()
                             if not k.startswith("train") and k != "flops"}
    print(f"attn_block phase: {time.perf_counter() - t_ab:.1f} s", flush=True)

    # -- attention at S = 1024: APF slim2 with npoint 1024, then the forward
    #    and backward kernels alone on its block 0 --------------------------
    t_long = time.perf_counter()
    long = apf_long_phase(torch, dev, _build, model, LONG_NPOINT, LONG_BATCH, P4P_POINTS, SEED + 5,
                          ("fps", "knn", "group_encoder", *GROUP_MLP_COUNTERS, "apf_block", "attention"),
                          ("group_encoder_chain",))
    with torch.inference_mode():
        lblk = long["block"]
        qkv_l = linear(layer_norm(long["tokens"], lblk.norm1), lblk.attention.qkv).contiguous()
        Bl, Sl = qkv_l.shape[:2]
        a_l = attention_kernel.mha_qkv(qkv_l, heads)
        d = held("mha_qkv S=1024", a_l, attention_kernel.reference_mha_qkv(qkv_l, heads),
                 f"{tuple(qkv_l.shape)} heads {heads}")
        att_long = dict(
            max_abs_err=d, ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv(qkv_l, heads), 5),
            plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv(qkv_l, heads), 2),
            **bound(4.0 * Bl * Sl * Sl * E, nbytes(qkv_l, a_l)))
        q, k, v = heads_of(qkv_l, heads)
        att_long["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, v), 5)
        del q, k, v
    bwd["S=1024"] = attention_bwd_phase(torch, "S=1024", qkv_l, heads, SEED + 6, plain_iters=2)
    print(f"S=1024 phase: {time.perf_counter() - t_long:.1f} s", flush=True)
    torch.cuda.synchronize()

    # -- attention above the blocks' gate: APF slim2 with npoint 1536, whose
    #    blocks run unfused, then the attention kernel alone on its block 0 --
    t_longer = time.perf_counter()
    longer = apf_long_phase(torch, dev, _build, model, LONGER_NPOINT, LONGER_BATCH, LONGER_POINTS,
                            SEED + 7, ("fps", "group_encoder", *GROUP_MLP_COUNTERS, "mha_qkv"),
                            ("apf_block", "attention", "group_encoder_chain"))
    with torch.inference_mode():
        lblk = longer["block"]
        qkv_x = linear(layer_norm(longer["tokens"], lblk.norm1), lblk.attention.qkv).contiguous()
        Bx, Sx = qkv_x.shape[:2]
        a_x = attention_kernel.mha_qkv(qkv_x, heads)
        d = held(f"mha_qkv S={Sx}", a_x, attention_kernel.reference_mha_qkv(qkv_x, heads),
                 f"{tuple(qkv_x.shape)} heads {heads}")
        att_longer = dict(
            max_abs_err=d, ms=cuda_ms(torch, lambda: attention_kernel.mha_qkv(qkv_x, heads), 5),
            plain_ms=cuda_ms(torch, lambda: attention_kernel.reference_mha_qkv(qkv_x, heads), 2),
            **bound(4.0 * Bx * Sx * Sx * E, nbytes(qkv_x, a_x)))
        q, k, v = heads_of(qkv_x, heads)
        att_longer["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, v), 5)
        del q, k, v, a_x
    bwd[f"S={Sx}"] = attention_bwd_phase(torch, f"S={Sx}", qkv_x, heads, SEED + 9)
    print(f"S={Sx} phase: {time.perf_counter() - t_longer:.1f} s", flush=True)
    torch.cuda.synchronize()

    # -- groups of 24 rows (C5): APF slim_k24 serving one request of 32 ------
    t_k24 = time.perf_counter()
    k24_model = AdaptPointFormer(**apf_preset_config("slim_k24"))
    randomize(torch, k24_model, torch.Generator().manual_seed(SEED + 31))
    k24 = apf_long_phase(torch, dev, _build, k24_model, cfg["npoint"], LONG_BATCH, POINTS, SEED + 32,
                         ("fps", "knn", "group_encoder_chain", "apf_block", "attention"),
                         ("group_encoder", *GROUP_MLP_COUNTERS), preset="slim_k24")
    del k24_model
    print(f"slim_k24 phase: {time.perf_counter() - t_k24:.1f} s", flush=True)

    # -- the f32 and any-head-dim kernels at the f32 Pix4Point's block 0 -----
    with torch.inference_mode():
        fblk = p4p32["block"]
        xf = p4p32["tokens"].reshape(-1, p4p32["tokens"].shape[-1]).contiguous()
        Mf, Ef = xf.shape
        wf = vit_block_kernel.vit_block_weights(fblk, torch.float32)
        a_f = layer_norm(xf, fblk.norm2).contiguous()
        gk, _ = gemm(a_f, wf[8], wf[9], act="gelu", out_dtype=torch.float32)
        gk2, _ = gemm(a_f, wf[8], wf[9], act="gelu", out_dtype=torch.float32)
        gp, _ = gemm_kernel.reference_gemm(a_f, wf[8], wf[9], act="gelu", out_dtype=torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(gk, gk2):
            fail("gemm_f32: two runs differ")
        d, r = rel_err(torch, gk, gp)
        print(f"gemm_f32 fc1 ({Mf}, {Ef}) -> {wf[8].shape[0]} [GELU, f32 out]: max|d| / max|ref| "
              f"{r:.3g} (bound {F32_REL_TOL:.3g}); repeats bit-equal", flush=True)
        if not r <= F32_REL_TOL:
            fail("gemm_f32 disagrees with its plain version")
        # 3xTF32 on the tensor cores: three TF32 products per f32 product
        flops = 2.0 * Mf * wf[8].numel()
        fc1 = lambda inst=None: gemm(a_f, wf[8], wf[9], act="gelu", out_dtype=torch.float32,  # noqa: E731
                                     instance=inst)
        results["gemm_f32"] = dict(
            shape=f"fc1 ({Mf}, {Ef}) -> {wf[8].shape[0]}, GELU", max_abs_err=d,
            ms=cuda_ms(torch, fc1, 5),
            plain_ms=cuda_ms(torch, lambda: gemm_kernel.reference_gemm(
                a_f, wf[8], wf[9], act="gelu", out_dtype=torch.float32), 2),
            **bound(3.0 * flops, nbytes(a_f, wf[8], wf[9], gk), PEAK_TF32),
            # F.linear in full f32: torch.backends.cuda.matmul.allow_tf32 is False (set above)
            library_ms=cuda_ms(torch, lambda: torch.nn.functional.linear(a_f, wf[8], wf[9]), 5))
        g64, _ = fc1("128x64")
        torch.cuda.synchronize()
        if not rel_err(torch, g64, gp)[1] <= F32_REL_TOL:
            fail("gemm_f32 128x64 disagrees with its plain version at fc1")
        print(f"time gemm_f32 fc1: kernel ({gemm_kernel.gemm_f32_instance(wf[8].shape[0])}) "
              f"{results['gemm_f32']['ms']:.4f} ms, {3.0 * flops / results['gemm_f32']['ms'] / 1e9:.1f} TFLOP/s "
              f"of TF32 products; 128x64 {cuda_ms(torch, lambda: fc1('128x64'), 5):.4f} ms; bound "
              f"{results['gemm_f32']['bound_ms']:.4f} ms (3xTF32), {flops / PEAK_F32 * 1e3:.4f} ms on the "
              f"CUDA cores; F.linear f32 (allow_tf32 {torch.backends.cuda.matmul.allow_tf32}) "
              f"{results['gemm_f32']['library_ms']:.4f} ms", flush=True)
        del g64, gk2
        del gk, gp
        qkv_f = linear(layer_norm(p4p32["tokens"], fblk.norm1), fblk.attn.qkv).contiguous()
        ablk = apf32["block"]
        qkv_a = linear(layer_norm(apf32["tokens"], ablk.norm1), ablk.attention.qkv).contiguous()
    # the any-head-dim pair at the f32 models' block 0 and the head dim 16 model's
    any_p4p = attention_any_case(torch, "f32 Pix4Point block 0", qkv_f, fblk.num_heads, SEED + 23)
    any_flops = {name: r.pop("flops") for name, r in any_p4p.items()}  # computed, not measured: off the line
    results.update(any_p4p)
    attention_any_case(torch, "f32 APF block 0", qkv_a, ablk.num_heads, SEED + 24)
    attention_any_case(torch, "head dim 16 model block 0", small["qkv"], SMALL_CONFIG["num_heads"], SEED + 25,
                       iters=10)
    del qkv_f, qkv_a
    saved = {
        "APF": launch_weight_saving(torch, "APF slim2", model.blocks, lambda b: block_kernel.apf_launch_weights(
            block_kernel.apf_block_weights(b), torch.bfloat16, dev)),
        "Pix4Point": launch_weight_saving(torch, "Pix4Point vit_small", vit.blocks,
                                          lambda b: vit_block_kernel.vit_block_weights(b, torch.bfloat16)),
        "renderer": launch_weight_saving(torch, "renderer vit_b_16", rend["model"].vit.encoder_layer,
                                         lambda b: serial_block_kernel.serial_block_weights(b, torch.bfloat16)),
    }
    del saved

    def fmt(r, flops=None):
        lib = "none" if r.get("library_ms") is None else f"{r['library_ms']:.4f} ms"
        line = (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']}), library call {lib}")
        if flops is not None:  # useful FLOPs: 4 B S^2 E of attention (+ 8 B S E^2 of projection;
            # 10 B S^2 E for the attention backward)
            line += (f"; {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
                     f"{r['ms'] / r['library_ms']:.2f}x the library call")
        return line

    attn_flops = lambda t: 4.0 * t.shape[0] * t.shape[1] ** 2 * t.shape[2] / 3

    for name, res in apf_shapes.items():
        print(f"time {name} at the APF shape {res['shape']}: {fmt(res)}", flush=True)
    for name, res in more_shapes.items():
        print(f"time {name} at {res['shape']}: {fmt(res)}", flush=True)
    for name, res in results.items():
        if name == "mha_qkv_bwd":
            continue  # printed below with the other backward shapes
        flops = {"mha_qkv": attn_flops(qkv), "attn_block": 8.0 * B * G * E * E + 4.0 * B * G * G * E,
                 **any_flops}
        print(f"time {name} at {res['shape']}: {fmt(res, flops.get(name))}", flush=True)
    print(f"time attention S=513 {tuple(qkv5.shape)} heads {vh}: {fmt(att513, attn_flops(qkv5))}",
          flush=True)
    print(f"time attention S=197 {tuple(qkv197.shape)} heads {rh}: {fmt(att197, attn_flops(qkv197))}",
          flush=True)
    print(f"time attention S=1024 {tuple(qkv_l.shape)} heads {heads}: "
          f"{fmt(att_long, attn_flops(qkv_l))}", flush=True)
    print(f"time attention S={Sx} {tuple(qkv_x.shape)} heads {heads}: "
          f"{fmt(att_longer, attn_flops(qkv_x))}", flush=True)
    for label, res in bwd.items():
        print(f"time attention backward {label} {res['shape']}: {fmt(res, res['flops'])}", flush=True)
    for label, res in ab.items():
        print(f"time attn_block {label} {res['shape']}: {fmt(res, res['flops'])}; forward + "
              f"backward: kernel path {res['train_ms']:.4f} ms, plain path "
              f"{res['train_plain_ms']:.4f} ms", flush=True)
    for name, res in quant_shapes.items():
        print(f"time quant_dense {name} {res['shape']}: {fmt(res)} (the int8 product alone, "
              f"torch._int_mm); {res['ops'] / res['ms'] / 1e9:.1f} TOP/s; its row quantizer alone "
              f"{res['quantizer_ms']:.4f} ms; the bf16 GEMM kernel at this shape "
              f"{res['gemm_ms']:.4f} ms", flush=True)
    paths = (counts, train_counts, train_long_counts, p4p_train_counts, rend_train_counts, p4p["counts"],
             rend["counts"], quant["counts"], ab_counts, knn_wide_counts, long["counts"], longer["counts"],
             p4p_off_counts, apf32["counts"], p4p32["counts"], small["serve_counts"],
             small["train_counts"], k24["counts"], *io_counts, *ingest_counts, *parallel_counts)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c.get(name, 0) for c in paths), **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    for entry in line["kernels"]:
        if set(entry) != KERNEL_KEYS:
            fail(f"kernel entry {entry['name']}: keys {sorted(set(entry) ^ KERNEL_KEYS)} are not the kernels line's")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack", "pointvit_tpu"))
    if bad:
        fail(f"the port imported JAX or the JAX package: {bad[:5]}")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    t_start = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
