"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. build the CUDA kernels from src/repro_torch/csrc (nvcc, all at once);
  2. the codec kernels against their plain versions, exhaustively, bit-exact;
  3. the posit GEMM kernel against its plain version at the serving shapes
     of qwen2.5-14b (decode and prefill), ragged shapes, p8 at es 0-3, bf16
     weights and p16 weights under f32 compute (the f32-FMA kernels, M = 4
     and 64); its decode rows bit for bit the same at M = 1, 4 and 8;
     p16 weights on the tensor cores (bf16 compute, the mixed path's
     q/k/v/o) at both qwen p16 shapes, M = 1, 4, 8 and 64, with f32, bf16
     and p8 activations, on every code drawn uniformly and with +-maxpos and
     +-minpos, their decode rows bit for bit the same at M = 1, 4 and 8, and
     every p16 code at es 0-3 through one-hot rows bit for bit the plain
     version's bf16 rounding;
     from 9 to 64 rows on the tensor-core pairs the mid-M kernel
     (``posit_gemm_mid.cu``): p8 at every qwen2.5-14b shape at M = 16, 32
     and 64, packed p8 and p16 at the attention projections' shapes at M =
     16 and 32 (and every p16 code at M = 16), each within the same bound,
     counted under ``posit_gemm_mid_tc``, two calls bit for bit the same,
     rows 0-8 bit for bit the same at M = 9, 16, 32 and 64; the ragged
     shapes it refuses (N not a multiple of 16) on the 64-row tile;
     the GEMM's packed-p8 variants (tensor cores under bf16 compute, f32 FMA
     under f32) at every qwen2.5-14b linear shape, M = 8 and 64, against
     the packed plain version and against the unpacked kernel on
     ``unpack_p8`` of the same codes, their decode rows bit for bit the same
     at M = 1, 4 and 8;
     past LARGE_M rows the large-M kernels (``posit_gemm_large.cu``): the
     wgmma kernel at qwen2.5-14b's four prefill shapes (q/o, k/v, gate/up,
     down; p8) at M = 4,032 and 1,024, the long context's and the paged
     path's prompts, p8_1 at M = 130 and p16 at M = 200, a
     ragged p8_2 tile (M = 1,000), bf16 weights at the training shape 4096 x
     3072 x 8192, p16 weights at M = 1,024, p8 in and out, packed p8 at M =
     130 and 1,024, and the 128 x 128 f32-FMA tile on f32 weights at 4096 x
     3072 x 8192, p16 at M = 1,024 and packed p8 at M = 130 and 1,024: each
     within the same bound (posit out within 1 ulp), counted under its own
     launch key, two calls bit for bit the same;
     every whisper-medium linear (q/k/v and frame_proj with a bias, wo
     and the MLP down with a bias and the residual, the MLP up with a bias
     and gelu) at the encoder's 6,000 rows (the wgmma kernel) and a decode
     step's 4; every gemma3-4b linear (q, k/v, o with the residual, gate
     with silu, up, down with the residual) at a decode step's 4 rows and
     a 1,536-token prefill (the wgmma kernel); the calibration forward's products on float (bf16) weights:
     phi3-mini-3.8b's q/o, gate (silu), down (the residual) and lm_head at
     M = 256 (the wgmma kernel) and olmoe-1b-7b's expert products at C =
     40 rows (the mid-M kernel);
     the quire GEMM kernel against its plain version, bit for bit, at
     phi3-mini-3.8b's shapes, and against itself unsplit, on Gaussian
     operands and on wide-span ones (every non-NaR code, minpos and maxpos
     in one chunk) that send products through its per-product branch; the
     share of products that take that branch, per case; the quire GEMM on
     packed and on unpacked p8 weights, bit for bit the same;
  4. the decode-attention kernel against its plain version (ATTN_CHECKS:
     qwen2.5-14b's and phi3-mini-3.8b's heads, head_dim 256 at 7 q-heads a KV
     head and at gemma3-4b's 2 (8/4, S 1,600), whisper-medium's cross read
     (16/16 heads, d 64, S 1,500, the no-append mode), p8, p16 and f32 KV,
     ragged rows, S up to 4,096), and its fused append (the decode step's
     call) at qwen's heads at S 80 and 4,096, at whisper-medium's
     self-attention (16/16, d 64, S 64, ragged positions) and at gemma3-4b's
     heads (8/4, d 256): a global layer's append at S 1,600 and a local
     layer's rolling append over a full window (S = len = 1,024, the row
     written at lens % 1,024 inside the buffer; APPEND_CHECKS): each case within the
     f32 contract's limit and a tight one that two bf16 controls must fail,
     the cache codes bit for bit those of the encode kernel and the row
     write, the output bit for bit the unfused call's, each row's bits alone
     and in the batch, the CPU emulation's warps a block the kernel's; its
     paged mode (the block table read inside the kernel) at qwen's heads,
     p8 and p16, bt 1, 16 and 32, over shuffled pools with sentinel tails
     and NaR-filled recycled pages, lengths 0, 1, 300 and 4,096, and at the
     paged path's 4-slot shape (W 66 pages of 16): bit for bit
     the dense kernel on the de-paged cache, within both limits of the plain
     version, its paged append's codes bit for bit the encode kernel + the
     paged row write (``check_paged_attention``); the
     softmax kernel against its plain version (within 1 posit ulp), up to
     qwen's vocabulary, with a NaR row;
     the paper's ISA entry points on the card against the CPU: the
     true-posit ALU (``core/alu.py``) on every p8 pair and 2^18 p16 pairs
     at es 0-3, a chain of quire ops, and the eight fcvt ops
     (``core/convert.py``, the codec kernels) on every p8 and p16 code and
     a float sweep, bit for bit (``check_alu_fcvt``); ``posit_dot``'s fused
     and unfused dataflows at Table IV's sizes (F32, P16_1, P8_0, n = 4 to
     1,024) and ``posit_gemv`` (n = 4 to 4,096) within the GEMM bound, the
     unfused form's two decode launches counted (``check_dataflows``);
  5. the reduced qwen2.5-14b (P8_SERVE, and the per-layer presets
     p8-packed and attn-p16-mlp-p8) and the reduced phi3-mini-3.8b (p16
     under the quire) on the card against the same models on the CPU (plain
     versions), the reduced qwen2.5-14b on a 2 x 300-token prompt, whose
     prefill linears run on the wgmma kernel, and the reduced olmoe-1b-7b
     (P8_SERVE and attn-p16-mlp-p8), granite-moe-3b-a800m, the reduced
     whisper-medium (the encoder, the cross K/V, 8 teacher-forced and 4
     greedy steps; ``check_small_whisper``) and the reduced gemma3-4b
     widened to 6 layers (layer 5 global; a 30-token prompt past the window
     of 16, decode writes crossing the rolling buffers' end; every KV
     stack's lengths equal). Then the
     paths, each with
     every kernel's launch count set to 0 just before it and read just after:
     - qwen2.5-14b at full width and depth, random weights from a seed,
       P8_SERVE, 8 requests (prompt 64, gen 16, 4 slots, greedy) through the
       continuous-batching engine;
     - the same under ``--policy p8-serve --precision-policy
       attn-p16-mlp-p8``: q/k/v/o at p16_1 on the tensor-core kernel's p16
       route, gate/up/down and lm_head in packed p8 lanes on the packed
       tensor-core variant, K/V at p8;
     - qwen2.5-14b at full width and depth under attn-p16-mlp-p8 over an f32
       base (``--policy none``), 4 requests (prompt 32, gen 8): the packed
       lanes on the packed f32-FMA variant, q/k/v/o on the f32-FMA kernels;
     - phi3-mini-3.8b at full width and depth under
       weights=p16_1,kv=p16_1,dataflow=quire, 4 requests (prompt 32, gen 8,
       4 slots, greedy): every linear through the quire GEMM;
     - the long context: qwen2.5-14b at full width and depth, P8_SERVE, 4
       requests of 4,032 prompt tokens and 64 generated, 4 slots, S_max
       4,096 (its prefills on the wgmma kernel);
     - the posit softmax entry point (core.dot.posit_softmax) on the paper's
       softmax rows and on phi3's logit rows;
     - the paged path: qwen2.5-14b at full width and depth, P8_SERVE, 16
       requests of 1,024 prompt tokens at 90% overlap (922 shared tokens)
       and 32 generated, S_max 1,056, pages of 32,768 B (16 tokens), served
       by the slot grid and the paged engine at 4 slots (the pool the
       grid's bytes, 264 blocks) and at 16 slots (the same 264 blocks):
       paged and grid bit for bit at both, every 16-slot decode step's 337
       linears on the mid-M kernel and none on the 64-row tile, 15 prefix
       hits of 912 tokens,
       all 16 admitted at once at 16 slots, a fork's two streams equal
       through copy-on-write, no dense attention launch, the prefills on
       the wgmma kernel (``run_paged_path``);
       then ``serve(paged=True, page_bytes=32768)`` through the entry point;
     - the moe path: olmoe-1b-7b at full width and depth (16 layers, 64
       experts top-8), P8_SERVE, 8 requests (prompt 64, gen 16, 4 slots,
       greedy) through ``serve``, every expert product a GEMM-kernel launch
       (3,153 decode-tile launches a decode step, 3,152 mid-M launches a
       prefill, counted exactly: ``run_moe_path``); then the slot grid and
       the paged engine on the same requests, bit for bit
       (``run_moe_paged``);
     - the whisper path: whisper-medium at full width and depth (24
       encoder and 24 decoder layers, d 1,024, 16/16 heads, d_ff 4,096,
       1,500 frames), P8_SERVE, through ``serve_static``: a batch of 4,
       the encoder over seeded frames, a 32-token prompt teacher-forced
       through the captured decode step and 32 greedy tokens, every GEMM,
       attention and encode launch counted exactly (``run_whisper_path``);
       then the same batch with the step captured and run eagerly, every
       step's logits and both caches bit for bit, the captured step
       profiled (device time, idle share, launches by kernel) and the
       encoder timed (``whisper_graph_vs_eager``);
     - the gemma3 path: gemma3-4b at full width and depth (34 layers, 5
       local of window 1,024 to 1 global, RoPE bases 1e4 and 1e6, d 2,560,
       8/4 heads, head_dim 256, a tied 262,144-word vocabulary), P8_SERVE,
       4 requests of 1,536 prompt tokens and 64 generated, 4 slots, S_max
       1,600, through ``serve`` (every local cache wraps in prefill and is
       written inside its buffer in decode), each decode step 238 GEMM
       launches, 34 attention launches and no encode launch, counted
       exactly (``run_gemma3_path``); the same shape of run through the
       captured grid engine and its eager twin, every step's logits bit
       for bit, the step's device ms by the posit GEMM, attention, the tied
       read-out and the glue, and the read-out timed alone
       (``gemma3_graph_vs_eager``); ``serve_static`` at 4 x (1,536 + 16)
       (``run_gemma3_static``);
     and a profiled decode step of each served model, of the long context
     and of the paged engine (48 paged attention launches a step), each
     from two engines on the same params and requests: the
     engine as shipped, which replays its decode step from a captured CUDA
     graph, and its eager twin (``EagerTwin``, the step op by op), whose
     tokens, every decode step's logits (bit for bit; on P8_SERVE through
     a mid-flight ``apply_policy`` to f32 compute), launch counts and
     profiled kernels must agree,
     with the step's wall time, device time, idle share and decode
     tokens/s of both on a ``graph_vs_eager`` line a path (olmoe's too;
     every step one
     attention launch a layer, no encode launch
     but the quire linears' own, one a call, and no index kernel but the
     embedding's: the KV rows are written inside the attention kernel; the
     P8_SERVE step must run no split-K epilogue kernel; the mixed step 192
     p16 and 145 packed tensor-core GEMM launches, no p16 f32-FMA kernel
     and no split-K epilogue kernel; the quire step one
     kernel a quire GEMM call, no readout or split-sum kernel), with the
     quire step's share of per-product-branch products;
  5c. the calibration path (``calib/``), after the served paths' memory
     is freed (``run_calib_phi3``, ``run_calib_olmoe``): phi3-mini-3.8b at
     full width and depth, float weights from seed 0, the p8-serve base,
     its loss observed over 4 batches of 4 x 64 tokens (the launch counts
     set to 0 just before and read just after) and searched at 1x and 1.5x
     the p8 floor; ``calibrate_model`` chooses the same again; (a) the
     observed loss is the unobserved loss bit for bit; (b) at attn/wq,
     mlp/down and lm_head the weight histogram is 4 times a float64 numpy
     recount of the site's tensors on the host, the act count 4 x 256 x
     d_in a layer; (c) the artifact saved, reloaded through ``@path`` and
     quantized again gives the same codes; (d) on a fifth batch the
     calibrated 1x policy's final hidden state is nearer the float
     forward's (``TransPolicy()``) than the p8-weights preset's; (e) at
     1.5x the bytes keep to the budget and some site is p16; one loss
     timed unobserved and observed (device ms by codec, GEMM and torch
     kernels, the observer's share, launches a forward); the calibrated
     policy and the p8-weights preset served (4 slots, 8 x (64 + 16)) and
     profiled, graph ≡ eager. olmoe-1b-7b the same at 1x, the moe/* sites
     present, every expert product of the observed run on the mid-M
     kernel at C = 40 (counted exactly). The reduced olmoe's ``lm_loss``
     (ce, aux) and hidden state on the card within the CPU parity test's
     bounds (``check_small_moe_loss``);
  5t. the training path (``repro_torch.launch.train``), after phase 5's
     decode profiles: (a) reduced qwen2.5-14b and phi3-mini-3.8b under
     ``none`` and ``p16-train``, three train steps on the card against the
     same on the CPU, each step from the card's state: the loss within
     1e-5 relative, every gradient leaf within 1e-4 of its largest
     magnitude, the update on the card's gradients within 8 f32 ulps, p16
     moment codes within 1 code (``check_train_reduced``); (b) the float
     linear's backward (``FloatLinear``: the GEMM kernel forward,
     torch.matmul backward) at M = 4,096 and phi3's q/o, gate/up (silu),
     down and lm_head shapes, f32 and bf16 compute, y, dx, dw and db within
     stated bounds of a float64 autograd (``check_linear_backward``); (c)
     ``train.main`` at phi3-mini-3.8b's full width and 16 of its 32 layers,
     8 x 512 tokens a step, every forward linear on the 128 x 128 f32-FMA
     tile, with the launch counts set to 0 just before and
     read just after: ``p16-train`` for 6 steps (every loss finite, the
     last below the first; one more step with every codec launch of layer
     0's straight-through weights and of lm_head's moments bit for bit the
     plain codec's, one with no CPU tensor holding data and no host sync on
     its path) and ``none`` for 3, each with one step profiled (its
     launches the run's a step): a ``train_path`` line a policy (losses,
     step wall and device time, idle share, tokens/s, peak memory,
     launches and device ms a step of ``posit_gemm``, ``posit_encode``,
     ``posit_decode`` and the backward's products) (``run_train_path``);
  6. each kernel timed at its path's shape beside its bound, its plain
     version and, where one exists, a single PyTorch call; the GEMM also at
     every decode (M = 4, and M = 16 and 32 on the mid-M kernel) and prefill
     (M = 64) shape of qwen2.5-14b, its packed
     variants there beside the unpacked kernel, the p16 weights (tensor
     cores under bf16 compute, f32 FMA under f32) at the attention
     projections' decode and prefill shapes, the quire GEMM at every phi3
     decode (M = 4, lm_head included) and prefill (M = 32) shape, decode
     attention read cold at S = 80 to 32,768 (``attention_timings``), and
     the paged kernel read cold at the paged path's 16-slot step (and there
     held to its plain version within phase 4's limits) and at S = 4,096
     with bt 16 and 1 beside the dense kernel on the same codes
     (``paged_attention_timings``); the training path's GEMM (float B, M =
     4,096, phi3's shapes, f32 and bf16 compute) beside torch.matmul and
     the 64-row tiles forced at the same shapes, and the codec at 32064 x
     3072 p16_1 (``train_timings``); the GEMM past the decode shapes, p8
     weights at qwen2.5-14b's prefill shapes at M = 4,032 and 1,024 and the
     crossover sweep at M = 64 to 512 (bf16 on p8 weights, f32 on f32 ones),
     each on the large-M kernels and on the 64-row tiles, beside
     torch.matmul (``large_gemm_timings``); fused against unfused
     ``posit_dot`` at Table IV's sizes and ``posit_gemv`` at the paper's
     GEMV sizes, device time and CUDA-event time of a call
     (``dataflow_timings``); whisper's cross read (S 1,500, d 64) beside
     SDPA and its encoder's up projection (6,000 x 1,024 x 4,096, bias and
     gelu) beside torch.matmul (``whisper_timings``); gemma3-4b's decode
     GEMM shapes at M = 4 and its global (S 1,600) and local (S 1,024)
     attention read cold, beside the bound, the plain version and a PyTorch
     call (``gemma3_timings``), and the summary's kernel rows again with the
     gemma3 path's launch counts (``gemma3_kernels``).
The lines before the last carry a {"kernels": [...]} summary and the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke_details.json. Every time is device
time from torch.profiler (``time_ms``). kernel_timings.py reuses phase 6's
GEMM (packed and p16 included), quire GEMM, softmax and attention timings to
compare two checkouts on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dot import posit_softmax  # noqa: E402
from repro_torch.core.pcsr import P8_SERVE, parse_policy  # noqa: E402
from repro_torch.core.types import (BF16, F32, P8_0, P8_1, P8_2, P8_3, P16_1,  # noqa: E402
                                    PositFmt)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.posit_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.posit_attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.posit_attention.ref import posit_decode_attention_ref  # noqa: E402
from repro_torch.kernels.posit_codec import ops as codec_ops  # noqa: E402
from repro_torch.kernels.posit_codec import ref as codec_ref  # noqa: E402
from repro_torch.kernels.posit_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.posit_gemm.ops import posit_gemm  # noqa: E402
from repro_torch.kernels.posit_gemm.ref import posit_gemm_ref  # noqa: E402
from repro_torch.kernels.posit_quire_gemm import ops as quire_ops  # noqa: E402
from repro_torch.kernels.posit_quire_gemm.ops import posit_quire_gemm  # noqa: E402
from repro_torch.kernels.posit_quire_gemm.ref import posit_quire_gemm_ref  # noqa: E402
from repro_torch.kernels.posit_softmax import ops as softmax_ops  # noqa: E402
from repro_torch.kernels.posit_softmax.ref import posit_softmax_ref  # noqa: E402
from repro_torch.launch.engine import (ContinuousBatchingEngine, Request,  # noqa: E402
                                       poisson_requests)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# bf16 / f32 / int8 (tensor cores, dense): data sheet; int32: 132 SMs x 64
# INT32 lanes x 1.98 GHz
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "int32": 16.7e12}
# The quire GEMM's bound: the least any implementation needs, one int8
# tensor-core MAC a product beside the bytes. The floor of a CUDA-core loop
# that places every product on its own in the quire (multiply, offset add,
# placing shift, one limb add) is kept beside it, as that loop's floor only.
QUIRE_OPS_PER_PRODUCT = 4
U = 2.0 ** -24              # f32 unit roundoff
DEV = torch.device("cuda")
QWEN = get_arch("qwen2.5-14b")
PHI3 = get_arch("phi3-mini-3.8b")
QUIRE_SPEC = "weights=p16_1,kv=p16_1,dataflow=quire"
MIXED = "attn-p16-mlp-p8"     # the per-layer preset of the mixed paths
GEMM_KN = ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120), (5120, 152064))
P16_KN = ((5120, 5120), (5120, 1024))   # the attention projections' shapes
PHI3_KN = ((3072, 3072), (3072, 8192), (8192, 3072))
PHI3_LM_HEAD = (3072, 32064)
SOFTMAX_SHAPES = ((1024, 8), (1024, 32), (1024, 128), (4, 32064))
QWEN_LOGITS = (4, 152064)
DETAILS: dict = {}
T_START = time.perf_counter()


def log(kind: str, **kw) -> None:
    """A phase's line, with ``t``: the seconds since the script started."""
    print(json.dumps({"phase": kind, "t": time.perf_counter() - T_START, **kw}), flush=True)


def bound_ms(nbytes: float, flops: float = 0.0, kind: str = "bf16") -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


# rows of the profiler's own work (CUPTI asking for a trace buffer), which
# carry device time and are no kernel of the program's
PROFILER_ROWS = ("Activity Buffer Request",)


# The profiler loses the records of a window's first launches, never one
# after them: from a prefix of an eager decode step (up to 93 kernels) to
# more than 50 ms of a window, on the H100, varying from process to process.
# So a window opens with a lead: a marker kernel (``torch.cuda._sleep``,
# "spin_kernel", no kernel of the program's) every PROFILE_RUNG_S; it closes
# with one more marker. A window is read only if its last lead marker and
# its closing marker were recorded; a window lost is taken again with a
# lead four times as long.
PROFILE_MARK = "spin_kernel"
PROFILE_RUNG_S = 0.005
PROFILE_LEAD_S = 0.05
PROFILE_TRIES = 4


def mark() -> None:
    torch.cuda._sleep(1000)


@contextlib.contextmanager
def profiled(*activities, lead: float = PROFILE_LEAD_S):
    """``torch.profiler.profile`` over ``activities`` whose body runs after
    ``lead`` seconds of markers; read it with ``device_events``."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=list(activities)) as prof:
        prof.rungs = max(1, round(lead / PROFILE_RUNG_S))
        for _ in range(prof.rungs):
            mark()
            time.sleep(PROFILE_RUNG_S)
        yield prof
        torch.cuda.synchronize()
        mark()
        torch.cuda.synchronize()
        time.sleep(PROFILE_RUNG_S)


def device_events(prof):
    """The device's own records of a ``profiled`` window's body (kernels,
    copies, sets), one each, but the profiler's own rows, and the start
    times of the body's markers after its first record (the closing one
    last); None if the window was lost (no lead marker or no closing marker
    recorded). Every window's lost lead goes into DETAILS["profiler"]."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU
           and not e.is_user_annotation and e.name not in PROFILER_ROWS]
    marks = sorted(e.time_range.start for e in dev if PROFILE_MARK in e.name)
    body = [e for e in dev if PROFILE_MARK not in e.name]
    first = min((e.time_range.start for e in body), default=float("inf"))
    last = max((e.time_range.start for e in body), default=float("-inf"))
    seen = sum(t < first for t in marks)
    closed = bool(marks) and marks[-1] > last
    stats = DETAILS.setdefault("profiler", {"windows": 0, "lost": [], "lead_lost_s_max": 0.0})
    stats["windows"] += 1
    if not (seen and closed):
        stats["lost"].append({"lead_s": prof.rungs * PROFILE_RUNG_S, "lead_markers_seen": seen,
                              "closed": closed, "records": len(body)})
        return None
    stats["lead_lost_s_max"] = max(stats["lead_lost_s_max"], (prof.rungs - seen) * PROFILE_RUNG_S)
    return body, marks[seen:]


def whole_window(body, *activities):
    """``body()`` under ``profiled`` until a window is seen whole, up to
    PROFILE_TRIES times: its profile, records and markers
    (``device_events``)."""
    lead = PROFILE_LEAD_S
    for _ in range(PROFILE_TRIES):
        with profiled(*activities, lead=lead) as prof:
            body()
        got = device_events(prof)
        if got is not None:
            return (prof, *got)
        lead *= 4
    raise RuntimeError(f"torch.profiler lost {PROFILE_TRIES} windows in a row: "
                       f"{DETAILS['profiler']['lost'][-PROFILE_TRIES:]}")


def kernel_name(name: str) -> str:
    """A device record's kernel name with its template arguments, without
    its parameter list and anonymous namespaces, at most 80 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].rstrip()[:80]
    return name[:80]


def time_ms(fn, *, windows: int = 5, calls: int = 10, kernels_out: dict | None = None) -> float:
    """Device time of one call of ``fn``: every kernel it launches, summed by
    torch.profiler over ``calls`` back-to-back calls, median over
    ``windows``, after a warm-up call. The windows run in one ``profiled``
    window, a marker after each; it is taken again (``whole_window``) if the
    profiler lost its start or any of them recorded no device time (counted
    in DETAILS["profiler_empty_windows"]). With ``kernels_out``, fills it
    with each kernel a call launches (``kernel_name``): [launches, device
    us] a call, over every window. CUDA events around the calls would time
    this host's dispatch instead: it is slower than most of these kernels,
    so the card idles between them."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        def body():
            for _ in range(windows):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                mark()

        _, events, marks = whole_window(body, ProfilerActivity.CUDA)
        us = [0.0] * windows
        for e in events:
            us[sum(t < e.time_range.start for t in marks)] += e.device_time_total
        if min(us) > 0:
            if kernels_out is not None:
                for e in events:
                    row = kernels_out.setdefault(kernel_name(e.name), [0.0, 0.0])
                    row[0] += 1 / (windows * calls)
                    row[1] += e.device_time_total / (windows * calls)
            return statistics.median(us) / calls / 1e3
        DETAILS["profiler_empty_windows"] = DETAILS.get("profiler_empty_windows", 0) + 1
    raise RuntimeError(f"torch.profiler recorded no device time in a window, {PROFILE_TRIES} "
                       "times")


def gen(seed: int) -> torch.Generator:
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return g


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).view(torch.int32)


def raw_bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's storage bits as integers (NaN payloads compare equal)."""
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.uint16: torch.int16}.get(x.dtype, x.dtype))


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over float results; a NaN on both sides (NaR)
    counts as agreement, a NaN on one side as an infinite difference."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    d = (g - w).abs()
    d = torch.where((g == w) | (g.isnan() & w.isnan()), torch.zeros_like(d), d)
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


# --------------------------------------------------------------- phase 2 ----

def check_codec() -> dict:
    mismatches = 0
    dec_err, enc_err = 0.0, 0
    for nbits, dt in ((8, torch.uint8), (16, torch.uint16)):
        codes = torch.arange(1 << nbits, device=DEV, dtype=torch.int32).to(dt)
        for es in range(4):
            for out in (torch.float32, torch.bfloat16):
                got = codec_ops.decode(codes, es, nbits=nbits, out_dtype=out)
                want = codec_ref.decode_ref(codes, es, nbits=nbits, out_dtype=out)
                mismatches += int((bits(got) != bits(want)).sum())
                dec_err = max(dec_err, max_abs_diff(got, want))
    g = gen(1)
    sweep = [torch.randn(1 << 20, generator=g, device=DEV) * s for s in (1e-3, 1.0, 1e3)]
    raw = torch.randint(0, 1 << 31, (1 << 20,), generator=g, device=DEV, dtype=torch.int32)
    sweep.append(raw.view(torch.float32))
    sweep.append(torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                               1e-40, -1e-42, 3e38, 2.0 ** -120, 2.0 ** 112], device=DEV))
    edges = torch.tensor([2.0 ** e for e in range(-126, 128)], device=DEV)
    sweep.append(torch.cat([edges, -edges, edges * 1.5, edges * (1 + 2.0 ** -23)]))
    x = torch.cat(sweep).contiguous()
    for nbits in (8, 16):
        for es in range(4):
            for ftz in (False, True):
                got = codec_ops.encode(x, es, nbits=nbits, ftz=ftz)
                want = codec_ref.encode_ref(x, es, nbits=nbits, ftz=ftz)
                d = (got.to(torch.int32) - want.to(torch.int32)).abs()
                mismatches += int((d != 0).sum())
                enc_err = max(enc_err, int(d.max()))
    assert mismatches == 0, f"codec kernels disagree with the plain codec on {mismatches} values"
    # decode: |value difference|; encode: |code difference|
    return {"mismatches": mismatches, "encode_inputs": x.numel(),
            "decode_max_abs_err": dec_err, "encode_max_abs_err": enc_err}


# --------------------------------------------------------------- phase 3 ----

def gemm_cases():
    """(name, M, K, N, b_fmt, a_dtype, out_fmt, bias, act, residual[, compute
    dtype]); the compute dtype defaults to bf16 for p8 and bf16 weights, f32
    for p16 and f32 ones."""
    cases = []
    # 16 and 32 rows: the 16-slot decode step and its neighbours, on the
    # mid-M kernel (csrc/posit_gemm_mid.cu), like the 64-token prefill's 64
    for M in (1, 4, 16, 32, 64):
        for K, N in GEMM_KN:
            bias = (K, N) in ((5120, 5120), (5120, 1024))         # q / k / v
            act = "silu" if (K, N) == (5120, 13824) else "none"   # gate
            res = (K, N) in ((13824, 5120), (5120, 5120))            # down / wo
            # as the model calls it: f32 activations, rounded to bf16 in the kernel
            cases.append((f"p8 M{M} {K}x{N}", M, K, N, P8_0, torch.float32, F32,
                          bias, act, res))
    # p16 weights compute in f32: the decode kernel, and at M > 8 the 64 x 64
    # FMA tile, each with its split-K epilogue kernel
    for M in (4, 64):
        cases.append((f"p16 f32 M{M} 5120x5120", M, 5120, 5120, P16_1, torch.float32, F32,
                      True, "gelu", True))
    cases.append(("p8 out M4 5120x1024", 4, 5120, 1024, P8_0, torch.bfloat16, P8_0,
                  True, "relu", False))
    # 5..8 rows and a column count off every vector width: the scalar edge
    cases.append(("p8 M6 5120x1001", 6, 5120, 1001, P8_0, torch.float32, F32,
                  True, "silu", True))
    # just past the decode tile, and a prefill tile, at ragged K and N, p8 at
    # es 1..3; bf16 weights on the tensor cores; p8 activations and out
    cases.append(("p8_1 M9 999x1001", 9, 999, 1001, P8_1, torch.float32, F32,
                  True, "gelu", True))
    cases.append(("p8_2 M64 1030x1000", 64, 1030, 1000, P8_2, torch.float32, F32,
                  True, "silu", True))
    cases.append(("p8_3 M9 5120x5120", 9, 5120, 5120, P8_3, torch.bfloat16, F32,
                  False, "relu", True))
    cases.append(("p8_2 M4 5120x13824", 4, 5120, 13824, P8_2, torch.float32, F32,
                  False, "none", False))
    cases.append(("p8_3 M64 13824x5120", 64, 13824, 5120, P8_3, torch.float32, F32,
                  False, "none", True))
    cases.append(("bf16 M4 5120x1024", 4, 5120, 1024, BF16, torch.float32, F32,
                  True, "none", False))
    cases.append(("bf16 M64 777x1001", 64, 777, 1001, BF16, torch.bfloat16, F32,
                  True, "silu", True))
    cases.append(("p8 x p8 out M64 5120x1024", 64, 5120, 1024, P8_0, P8_0, P8_0,
                  True, "none", False))
    # olmoe-1b-7b's products as its moe layers call them: the experts at C =
    # 8 rows (a 4-slot decode step: the decode tile) and C = 16 (a 64-token
    # prefill: the mid-M kernel), the router's 64 columns (at 64 rows below
    # the mid-M kernel's 128-column stream-K tile), attention, lm_head's
    # 50,304 columns at a prefill's one row and a decode step's four
    for M in (8, 16):
        for K, N, act in ((2048, 1024, "silu"), (2048, 1024, "none"), (1024, 2048, "none")):
            cases.append((f"olmoe expert M{M} {K}x{N} {act}", M, K, N, P8_0, torch.float32,
                          F32, False, act, False))
    for M in (4, 64):
        cases.append((f"olmoe router M{M} 2048x64", M, 2048, 64, P8_0, torch.float32, F32,
                      False, "none", False))
        cases.append((f"olmoe attn M{M} 2048x2048", M, 2048, 2048, P8_0, torch.float32, F32,
                      False, "none", True))
    for M in (1, 4):
        cases.append((f"olmoe lm_head M{M} 2048x50304", M, 2048, 50304, P8_0, torch.float32,
                      F32, False, "none", False))
    # past LARGE_M rows, the large-M kernels: every prefill shape of the long
    # context's and the paged path's prompts as the model calls it (wgmma, a
    # posit B decoded to bf16 once for the call; k/v at M = 1,024 splits K),
    # ragged tiles, the training shapes' float weights (bf16 B on wgmma, f32
    # B on the 128 x 128 FMA tile), p16 weights on both, p8 out
    for M in (LONG_PROMPT, PAGED_PROMPT):
        for K, N in GEMM_KN[:4]:
            bias = (K, N) in ((5120, 5120), (5120, 1024))
            act = "silu" if (K, N) == (5120, 13824) else "none"
            res = (K, N) in ((13824, 5120), (5120, 5120))
            cases.append((f"p8 M{M} {K}x{N}", M, K, N, P8_0, torch.float32, F32,
                          bias, act, res))
    cases.append(("p8_1 M130 1032x1008", 130, 1032, 1008, P8_1, torch.float32, F32,
                  True, "gelu", True))
    cases.append(("p16 bf16 M200 5120x1024", 200, 5120, 1024, P16_1, torch.float32, F32,
                  True, "silu", True, torch.bfloat16))
    cases.append(("p8_2 M1000 1032x1008", 1000, 1032, 1008, P8_2, torch.float32, F32,
                  True, "gelu", True))
    cases.append(("bf16 M4096 3072x8192", 4096, 3072, 8192, BF16, torch.float32, F32,
                  False, "silu", False))
    cases.append(("f32 M4096 3072x8192", 4096, 3072, 8192, F32, torch.float32, F32,
                  False, "silu", False))
    cases.append(("p16 f32 M1024 5120x5120", 1024, 5120, 5120, P16_1, torch.float32, F32,
                  True, "none", True))
    cases.append(("p16 bf16 M1024 5120x1024", 1024, 5120, 1024, P16_1, torch.float32, F32,
                  True, "relu", False, torch.bfloat16))
    cases.append(("p8 x p8 out M257 1024x1024", 257, 1024, 1024, P8_0, P8_0, P8_0,
                  True, "none", True))
    # the calibration forward's products, float weights read as bf16 (the
    # straight-through forward): phi3-mini-3.8b at 4 x 64 tokens (M = 256,
    # the wgmma kernel) and olmoe-1b-7b's experts at C = 40 rows
    # (capacity(256, 8, 1.25, 64): the mid-M kernel)
    for K, N, act, res in ((3072, 3072, "none", False), (3072, 8192, "silu", False),
                           (8192, 3072, "none", True), (3072, 32064, "none", False)):
        cases.append((f"phi3 bf16 M256 {K}x{N} {act}", 256, K, N, BF16, torch.float32, F32,
                      False, act, res))
    for K, N, act in ((2048, 1024, "silu"), (2048, 1024, "none"), (1024, 2048, "none")):
        cases.append((f"olmoe expert bf16 M40 {K}x{N} {act}", 40, K, N, BF16, torch.float32,
                      F32, False, act, False))
    # every whisper-medium linear as the model calls it, at the encoder's
    # B * T = 4 x 1,500 rows (the wgmma kernel) and a 4-row decode step (the
    # decode tile): frame_proj, q/k/v and the cross k/v (bias); wo (bias,
    # the block residual); the MLP up (bias, gelu) and down (bias, residual)
    for M in (4, 6000):
        for part, K, N, act, res in (("qkv", 1024, 1024, "none", False),
                                     ("o", 1024, 1024, "none", True),
                                     ("up", 1024, 4096, "gelu", False),
                                     ("down", 4096, 1024, "none", True)):
            cases.append((f"whisper {part} M{M} {K}x{N}", M, K, N, P8_0, torch.float32, F32,
                          True, act, res))
    # every gemma3-4b linear as the model calls it (no bias; gate with silu,
    # wo and down with the block residual) at a 4-slot decode step (the
    # decode tile) and a 1,536-token prefill (the wgmma kernel)
    for M in (4, G3_PROMPT):
        for part, K, N, act, res in G3_LINEARS:
            cases.append((f"gemma3 {part} M{M} {K}x{N}", M, K, N, P8_0, torch.float32, F32,
                          False, act, res))
    return cases


def gemm_key(M, N, K, a_fmt, b_fmt, cd, packed=False) -> str:
    """The ``kernels.LAUNCHES`` key an aligned CUDA call of this shape adds to
    (``ops.gemm_route`` and ``ops.launch_counter``)."""
    a_kind, b_kind = gemm_ops._kind(a_fmt)[0], gemm_ops._kind(b_fmt, packed)[0]
    bf16 = cd == torch.bfloat16
    route = gemm_ops.gemm_route(M, N, K, a_kind, b_kind, bf16)
    tc = gemm_ops.uses_tensor_cores(a_kind, b_kind, bf16)
    if route == "mid_tc":
        return gemm_ops.launch_counter(b_kind, tc, mid=True)
    return gemm_ops.launch_counter(b_kind, tc, large=route.startswith("large"))


def make_gemm_inputs(M, K, N, b_fmt, a_dtype, bias, residual, seed=0):
    """a_dtype: a float dtype, or a p8 format for posit-coded activations."""
    g = gen(seed)
    a = torch.randn((M, K), generator=g, device=DEV)
    a = (codec_ops.encode(a, a_dtype.es, nbits=8) if isinstance(a_dtype, PositFmt)
         else a.to(a_dtype))
    w = torch.randn((K, N), generator=g, device=DEV) * K ** -0.5
    b = (w.to(torch.bfloat16) if b_fmt == BF16 else w if b_fmt == F32
         else codec_ops.encode(w, b_fmt.es, nbits=b_fmt.nbits))
    bi = torch.randn((N,), generator=g, device=DEV) * 0.1 if bias else None
    r = torch.randn((M, N), generator=g, device=DEV) if residual else None
    return a, b, bi, r


def operand_values(x: torch.Tensor, fmt) -> torch.Tensor:
    """A GEMM operand as f32 values: posit codes decoded, floats widened."""
    if isinstance(fmt, PositFmt):
        return codec_ref.decode_ref(x, fmt.es, nbits=fmt.nbits)
    return x.to(torch.float32)


def check_gemm_batch_invariance() -> dict:
    """The decode path as the model calls it (f32 activations, p8 weights,
    bf16 compute), epilogue included, at every decode shape: row i of the
    result at M = 1 and 4 is bit for bit row i at M = 8 (the decode tile);
    rows 0-8 at M = 9, 16 and 32 are bit for bit rows 0-8 at M = 64 (the
    mid-M kernel, whose plan does not depend on M: its 16-, 32- and 64-row
    wgmma sum each output alike)."""
    differing, mid_differing = 0, 0
    for K, N in GEMM_KN:
        a, b, bi, r = make_gemm_inputs(64, K, N, P8_0, torch.float32, True, True, seed=10)
        kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, compute_dtype=torch.bfloat16,
                  activation="silu")
        out = {M: bits(posit_gemm(a[:M].contiguous(), b, (0, 0, 0), bias=bi,
                                  residual=r[:M].contiguous(), **kw))
               for M in (1, 4, 8, 9, 16, 32, 64)}
        for M in (1, 4):
            differing += int((out[M] != out[8][:M]).sum())
        for M in (9, 16, 32):
            mid_differing += int((out[M][:9] != out[64][:9]).sum())
        del a, b, bi, r, out
    torch.cuda.empty_cache()
    assert differing == 0, f"GEMM decode rows depend on the batch: {differing} values differ"
    assert mid_differing == 0, \
        f"mid-M GEMM rows depend on the batch: {mid_differing} values differ"
    return {"shapes": len(GEMM_KN), "rows": (1, 4, 8), "differing_values": differing,
            "mid_rows": (9, 16, 32, 64), "mid_differing_values": mid_differing}


def gemm_plain(a, b, bi, r, kw, chunk=16384):
    """The plain version, over column blocks of B (the full-vocab weight's
    int64 decode temporaries would not fit at once)."""
    outs = []
    for n0 in range(0, b.shape[1], chunk):
        sl = slice(n0, n0 + chunk)
        outs.append(posit_gemm_ref(a, b[:, sl].contiguous(), kw["es"],
                                   a_fmt=kw["a_fmt"], b_fmt=kw["b_fmt"],
                                   out_fmt=kw["out_fmt"],
                                   compute_dtype=kw.get("compute_dtype"),
                                   bias=None if bi is None else bi[sl],
                                   residual=None if r is None else r[:, sl].contiguous(),
                                   activation=kw["activation"]))
    return torch.cat(outs, dim=1)


def gemm_bound_check(name, got, want, a, bvals, cd, K, bias=None, res=None) -> dict:
    """The GEMM bound between two f32 results that sum the same products,
    exact in f32 (bf16 operands, or values rounded once), in other orders:
    |diff| <= 2*K*u*(|A|@|B| + |bias|) + 8u*(|y| + |res|), with A's values
    ``a`` rounded to ``cd`` and the weight values ``bvals`` (a callable of a
    column slice) taken over column blocks. Returns the largest error and
    its ratio to the bound."""
    worst, ratio = 0.0, 0.0
    for n0 in range(0, got.shape[1], 16384):
        sl = slice(n0, n0 + 16384)
        scale = torch.matmul(a.to(cd).float().abs(), bvals(sl).abs())
        if bias is not None:
            scale = scale + bias[sl].abs()
        tol = 2 * K * U * scale + 8 * U * (want[:, sl].abs()
                                            + (res[:, sl].abs() if res is not None else 0))
        err = (got[:, sl] - want[:, sl]).abs()
        worst, ratio = max(worst, float(err.max())), max(ratio, float((err / tol).max()))
    assert ratio <= 1.0, f"{name}: error {worst} exceeds its bound"
    return {"max_abs_err": worst, "err_over_bound": ratio}


def check_gemm() -> dict:
    worst = 0.0
    worst_ratio = 0.0
    rows = []
    large_launches, mid_launches, repeat_differing = 0, 0, 0
    worst_large = {"posit_gemm_large_tc": 0.0, "posit_gemm_large_fma": 0.0,
                   "posit_gemm_mid_tc": 0.0}
    for name, M, K, N, b_fmt, a_dtype, out_fmt, bias, act, res, *cd in gemm_cases():
        a, b, bi, r = make_gemm_inputs(M, K, N, b_fmt, a_dtype, bias, res)
        a_fmt = (a_dtype if isinstance(a_dtype, PositFmt)
                 else BF16 if a_dtype == torch.bfloat16 else F32)
        cd = cd[0] if cd else (torch.bfloat16 if b_fmt == BF16 or
                               getattr(b_fmt, "nbits", 32) == 8 else torch.float32)
        kw = dict(es=(getattr(a_fmt, "es", 0), getattr(b_fmt, "es", 0),
                      getattr(out_fmt, "es", 0)), a_fmt=a_fmt, b_fmt=b_fmt,
                  out_fmt=out_fmt, activation=act, compute_dtype=cd)
        before = dict(kernels.LAUNCHES)
        got = posit_gemm(a, b, kw["es"], a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt,
                         bias=bi, residual=r, activation=act, compute_dtype=cd)
        # every launch under its route's key
        key = gemm_key(M, N, K, a_fmt, b_fmt, cd)
        assert kernels.LAUNCHES[key] == before[key] + 1, (name, key)
        if key in worst_large:
            # the large-M and mid-M kernels: a second call gives the same bits
            large_launches += key != "posit_gemm_mid_tc"
            mid_launches += key == "posit_gemm_mid_tc"
            again = posit_gemm(a, b, kw["es"], a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt,
                               bias=bi, residual=r, activation=act, compute_dtype=cd)
            repeat_differing += int((raw_bits(again) != raw_bits(got)).sum())
        want = gemm_plain(a, b, bi, r, kw)
        if out_fmt == F32:
            c = gemm_bound_check(
                f"GEMM {name}", got, want, operand_values(a, a_fmt),
                lambda sl: operand_values(b[:, sl].contiguous(), b_fmt), cd, K, bi, r)
            worst = max(worst, c["max_abs_err"])
            worst_ratio = max(worst_ratio, c["err_over_bound"])
            if key in worst_large:
                worst_large[key] = max(worst_large[key], c["max_abs_err"])
            rows.append({"case": name, "key": key, **c})
        else:
            # posit out: the f32 sums may round to neighbouring codes
            n = out_fmt.nbits
            d = (got.to(torch.int32) - want.to(torch.int32)) & ((1 << n) - 1)
            ulp = int(torch.minimum(d, (1 << n) - d).max())
            assert ulp <= 1, f"GEMM {name}: {ulp} posit ulps apart"
            rows.append({"case": name, "key": key, "max_code_ulps": ulp})
        del a, b, bi, r, got, want
    torch.cuda.empty_cache()
    assert repeat_differing == 0, \
        f"large- or mid-M GEMM: {repeat_differing} values differ between calls"
    assert mid_launches > 0, "no GEMM case ran on the mid-M kernel"
    DETAILS["gemm_checks"] = rows
    return {"cases": len(rows), "max_abs_err": worst, "max_err_over_bound": worst_ratio,
            "large_m_cases": large_launches, "mid_m_cases": mid_launches,
            "large_mid_repeat_differing": repeat_differing,
            "large_m_max_abs_err": worst_large}


def check_packed_gemm() -> dict:
    """The packed-p8 variants as the layers call them (f32 activations,
    packed p8_0 lanes, the epilogue of each projection): tensor cores under
    bf16 compute, f32 FMA under f32, at every qwen2.5-14b linear shape at
    M = 8 and 64 (bf16 at 64: the mid-M kernel), and under bf16 at M = 16
    and 32 at the attention projections' shapes (the mid-M kernel), each
    against the packed plain version and against the unpacked kernel on
    ``unpack_p8`` of the same codes (``check_gemm``'s bound), its rows at M =
    1 and 4 bit for bit rows of M = 8, and every launch counted under its
    route's key (``gemm_key``); and at M = 130 and 1,024 (q/o, gate/up)
    through the large-M kernels, counted under theirs."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.core.pack import pack_p8, unpack_p8

    rows, worst, worst_ratio, differing = [], 0.0, 0.0, 0
    for cd in (torch.bfloat16, torch.float32):
        for M in (8, 16, 32, 64, 130, 1024):
            # M = 16 and 32 (bf16 compute: the mid-M kernel) at the attention
            # projections' shapes; M = 130 and 1,024: the large-M kernels (B
            # unpacked to bf16 once for the call on wgmma), at the q/o and
            # gate/up shapes
            if M in (16, 32) and cd != torch.bfloat16:
                continue
            for K, N in (P16_KN if M in (16, 32) else GEMM_KN if M <= 64 else GEMM_KN[:3:2]):
                bias = (K, N) in ((5120, 5120), (5120, 1024))
                act = "silu" if (K, N) == (5120, 13824) else "none"
                res = (K, N) in ((13824, 5120), (5120, 5120))
                a, b, bi, r = make_gemm_inputs(M, K, N, P8_0, torch.float32, bias, res, seed=12)
                bp = pack_p8(b)
                del b
                kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, activation=act,
                          compute_dtype=cd)
                before = dict(kernels.LAUNCHES)
                got = posit_gemm(a, bp, (0, 0, 0), bias=bi, residual=r, b_packed=True, **kw)
                key = gemm_key(M, N, K, F32, P8_0, cd, packed=True)
                assert kernels.LAUNCHES[key] == before[key] + 1, key
                assert kernels.LAUNCHES["posit_gemm"] == before["posit_gemm"]
                b = unpack_p8(bp, K).contiguous()
                unpacked = posit_gemm(a, b, (0, 0, 0), bias=bi, residual=r, **kw)
                plain = torch.cat([
                    posit_gemm_ref(a, bp[:, n0:n0 + 16384].contiguous(), (0, 0, 0),
                                   bias=None if bi is None else bi[n0:n0 + 16384],
                                   residual=None if r is None else r[:, n0:n0 + 16384]
                                   .contiguous(), b_packed=True, **kw)
                    for n0 in range(0, N, 16384)], dim=1)

                def bvals(sl):
                    return codec_ops.decode(b[:, sl].contiguous(), 0, nbits=8)

                name = f"packed {'tc' if cd == torch.bfloat16 else 'fma'} M{M} {K}x{N}"
                row = {"case": name, "key": key}
                for ref_name, want in (("plain", plain), ("unpacked_kernel", unpacked)):
                    c = gemm_bound_check(f"{name} vs {ref_name}", got, want, a, bvals, cd, K,
                                         bi, r)
                    row[ref_name] = c
                    worst = max(worst, c["max_abs_err"])
                    worst_ratio = max(worst_ratio, c["err_over_bound"])
                if M == 8:
                    full = bits(got)
                    for m in (1, 4):
                        part = posit_gemm(a[:m].contiguous(), bp, (0, 0, 0), bias=bi,
                                          residual=None if r is None else r[:m].contiguous(),
                                          b_packed=True, **kw)
                        differing += int((bits(part) != full[:m]).sum())
                rows.append(row)
                del a, b, bp, bi, r, got, unpacked, plain
            torch.cuda.empty_cache()
    assert differing == 0, f"packed GEMM decode rows depend on the batch: {differing} differ"
    DETAILS["packed_gemm_checks"] = rows
    return {"cases": len(rows), "max_abs_err": worst, "max_err_over_bound": worst_ratio,
            "rows": (1, 4, 8), "differing_values": differing}


def check_p16_gemm() -> dict:
    """p16 weights on the tensor cores, as the mixed path calls them (bf16
    compute; f32 activations and each projection's epilogue: bias on q/k/v,
    the residual on o): at both qwen p16 shapes, M = 1, 4, 8, 16, 32 and 64
    (past 8 rows on the mid-M kernel), and
    with bf16 and p8 activations at M = 4 and 64, against the plain version
    within ``check_gemm``'s bound; on every non-NaR code drawn uniformly,
    and on Gaussian codes with +-maxpos and +-minpos, likewise; rows at M =
    1 and 4 bit for bit rows of M = 8; and every p16 code at es 0-3 through
    one-hot activation rows (M = 8, 16 and 64, one k step), where the
    kernel's result is the bf16 rounding of the decoded code itself: bit for
    bit the plain version's. Every launch counts under ``posit_gemm_p16``,
    or past 8 rows on a shape the mid-M kernel takes under
    ``posit_gemm_mid_tc``.
    ``max_abs_err`` is over the Gaussian cases; the wide-span ones, whose
    sums reach 2^28, report theirs apart."""
    rows, worst, edge_worst, worst_ratio, differing, exact_mismatch = [], 0.0, 0.0, 0.0, 0, 0
    cd = torch.bfloat16

    def run(name, a, a_fmt, b, es_b, bi=None, r=None, act="none"):
        kw = dict(es=(getattr(a_fmt, "es", 0), es_b, 0), a_fmt=a_fmt, b_fmt=P16_1,
                  out_fmt=F32, activation=act, compute_dtype=cd)
        before = dict(kernels.LAUNCHES)
        got = posit_gemm(a, b, kw["es"], a_fmt=a_fmt, b_fmt=P16_1, out_fmt=F32, bias=bi,
                         residual=r, activation=act, compute_dtype=cd)
        key = gemm_key(a.shape[0], b.shape[1], a.shape[1], a_fmt, P16_1, cd)
        assert key in ("posit_gemm_p16", "posit_gemm_mid_tc"), (name, key)
        assert kernels.LAUNCHES[key] == before[key] + 1, name
        assert kernels.LAUNCHES["posit_gemm"] == before["posit_gemm"], name
        return got, gemm_plain(a, b, bi, r, kw)

    def bounded(name, got, want, a, a_fmt, b, K, bi, r, edge=False):
        nonlocal worst, edge_worst, worst_ratio
        c = gemm_bound_check(
            name, got, want, operand_values(a, a_fmt),
            lambda sl: operand_values(b[:, sl].contiguous(), P16_1).to(cd).float(), cd, K,
            bi, r)
        if edge:
            edge_worst = max(edge_worst, c["max_abs_err"])
        else:
            worst = max(worst, c["max_abs_err"])
        worst_ratio = max(worst_ratio, c["err_over_bound"])
        rows.append({"case": name, **c})

    for K, N in P16_KN:
        bias, res = True, (K, N) == (5120, 5120)
        for M in (1, 4, 8, 16, 32, 64):
            a, b, bi, r = make_gemm_inputs(M, K, N, P16_1, torch.float32, bias, res, seed=13)
            got, want = run(f"p16 tc M{M} {K}x{N}", a, F32, b, 1, bi, r)
            bounded(f"p16 tc M{M} {K}x{N}", got, want, a, F32, b, K, bi, r)
            if M == 8:
                full = bits(got)
                for m in (1, 4):
                    part = posit_gemm(a[:m].contiguous(), b, (0, 1, 0), a_fmt=F32, b_fmt=P16_1,
                                      out_fmt=F32, bias=bi,
                                      residual=None if r is None else r[:m].contiguous(),
                                      compute_dtype=cd)
                    differing += int((bits(part) != full[:m]).sum())
        for a_dtype, a_fmt in ((torch.bfloat16, BF16), (P8_0, P8_0)):
            for M in (4, 64):
                a, b, bi, r = make_gemm_inputs(M, K, N, P16_1, a_dtype, bias, res, seed=14)
                name = f"p16 tc {a_fmt.name} act M{M} {K}x{N}"
                got, want = run(name, a, a_fmt, b, 1, bi, r, "silu")
                bounded(name, got, want, a, a_fmt, b, K, bi, r)
        del a, b, bi, r, got, want
    g = gen(15)
    for name, M, (K, N), kind in (("p16 all codes M4", 4, P16_KN[1], "all_codes"),
                                  ("p16 minmax M8", 8, P16_KN[0], "minmax")):
        a = torch.randn((M, K), generator=g, device=DEV)
        b = _quire_codes(g, (K, N), P16_1, kind, scale=K ** -0.5).to(torch.uint16)
        got, want = run(name, a, F32, b, 1)
        bounded(f"{name} {K}x{N}", got, want, a, F32, b, K, None, None, edge=True)
    # every code: 65,535 non-NaR codes and a zero in K rows, plus 8 columns
    # of zeros whose first holds NaR (its column reads NaN in every row)
    codes = torch.arange(1 << 16, device=DEV, dtype=torch.int32)
    codes = torch.cat([codes[codes != 0x8000], codes.new_zeros(1)])
    for es in range(4):
        for M in (8, 16, 64):
            # M = 16 pads to a column count the mid-M kernel takes (M = 64's
            # 1,032 columns stay on the 64-row tile)
            pad = 16 if M == 16 else 8
            b = torch.cat([codes.reshape(M, -1), codes.new_zeros((M, pad))], dim=1)
            b[0, -pad] = 0x8000
            b = b.to(torch.uint16).contiguous()
            a = torch.eye(M, device=DEV)
            got, want = run(f"p16 every code es{es} M{M}", a, F32, b, es)
            same = (bits(got) == bits(want)) | (got.isnan() & want.isnan())
            exact_mismatch += int((~same).sum())
    assert differing == 0, f"p16 GEMM decode rows depend on the batch: {differing} differ"
    assert exact_mismatch == 0, f"p16 tensor-core decode: {exact_mismatch} codes differ"
    torch.cuda.empty_cache()
    DETAILS["p16_gemm_checks"] = rows
    return {"cases": len(rows), "max_abs_err": worst, "wide_span_max_abs_err": edge_worst,
            "max_err_over_bound": worst_ratio, "rows": (1, 4, 8),
            "differing_values": differing, "every_code_mismatches": exact_mismatch}


def check_quire_packed() -> dict:
    """The quire GEMM through its front door on packed p8 weights gives the
    bits of the same codes unpacked (the quire's sum does not depend on the
    layout): phi3's gate/up shape at M = 4 and an odd K at M = 13, p16 and
    p8 activations."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.core.pack import pack_p8
    from repro_torch.core.pcsr import OperandSlots

    cases = []
    for M, K, N, a_fmt in ((4, 3072, 8192, P16_1), (13, 1001, 301, P8_2)):
        a, b, _, _ = make_quire_inputs(M, K, N, a_fmt, P8_0, False, False, seed=21)
        slots = OperandSlots(rs1=a_fmt, rs2=P8_0, rd=F32, dataflow="quire")
        got = quire_ops.quire_gemm(a, pack_p8(b), slots.with_packed())
        want = quire_ops.quire_gemm(a, b, slots)
        mismatches = int((_as_bits(got) != _as_bits(want)).sum())
        assert mismatches == 0, f"quire packed M{M} {K}x{N}: {mismatches} outputs differ"
        cases.append(f"M{M} {K}x{N} {a_fmt.name} x packed p8_0")
    return {"cases": cases, "mismatches": 0}


def quire_cases():
    """(name, M, K, N, a_fmt, b_fmt, out_fmt, bias, act, residual, kind)."""
    cases = []
    for M in (1, 4, 32):
        for K, N in PHI3_KN:
            act = "silu" if (K, N) == (3072, 8192) else "none"   # gate (up: none)
            # down, and 3072x3072 as wo at M = 4 (as wq, no epilogue, otherwise)
            res = K == 8192 or (M == 4 and (K, N) == (3072, 3072))
            cases.append((f"p16 M{M} {K}x{N}", M, K, N, P16_1, P16_1, F32, False, act, res,
                          "gauss"))
    cases.append(("p16 lm_head M4 3072x32064", 4, *PHI3_LM_HEAD, P16_1, P16_1, F32, False,
                  "none", False, "gauss"))
    cases.append(("p8 out M4 3072x3072", 4, 3072, 3072, P8_0, P8_0, P8_0, False, "none",
                  False, "gauss"))
    cases.append(("p8 out relu M4 3072x3072", 4, 3072, 3072, P8_2, P8_2, P8_0, True, "relu",
                  False, "gauss"))
    cases.append(("p16 x p8 M4 3072x8192", 4, 3072, 8192, P16_1, P8_0, F32, True, "none",
                  True, "gauss"))
    # 5..8 rows, a column count off every vector width, the gelu epilogue
    cases.append(("p16 out M6 3072x1001", 6, 3072, 1001, P16_1, P16_1, P16_1, True, "gelu",
                  True, "gauss"))
    # wide spans: every non-NaR code drawn uniformly, or minpos and maxpos in
    # one chunk of a row and of a column; products leave the window
    for name, M, a_fmt, b_fmt, out_fmt, kind, epi in (
            ("p16 all codes M4", 4, P16_1, P16_1, P16_1, "all_codes", False),
            ("p16 minmax M8", 8, P16_1, P16_1, F32, "minmax", True),
            ("p8 x p16 all codes M4", 4, P8_0, P16_1, F32, "all_codes", False),
            ("p8 x p16 minmax M4", 4, P8_0, P16_1, P16_1, "minmax", True),
            ("p8_0 all codes M4", 4, P8_0, P8_0, P8_0, "all_codes", False),
            ("p8_3 all codes M4", 4, P8_3, P8_3, P8_3, "all_codes", False),
            ("p8_3 minmax M32", 32, P8_3, P8_3, F32, "minmax", True)):
        cases.append((f"{name} 3072x1001", M, 3072, 1001, a_fmt, b_fmt, out_fmt, epi,
                      "silu" if epi else "none", epi, kind))
    return cases


def spans_window(fmt: PositFmt) -> bool:
    """Whether a format's scales span more than the quire GEMM's window:
    only then can an operand fall below its anchor (p8 at es 0 spans 12
    binades, inside the window of 21)."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.kernels.posit_quire_gemm.ref import window
    return 2 * ((fmt.nbits - 2) << fmt.es) > window(fmt.nbits)


def _quire_codes(g, shape, fmt, kind, scale=1.0):
    """Codes of normal values (gauss), of every non-NaR code drawn uniformly
    (all_codes), or gauss with +-maxpos and +-minpos in the first chunk of
    row 0 and of column 0 (minmax)."""
    n = fmt.nbits
    if kind == "all_codes":
        c = torch.randint(0, (1 << n) - 1, shape, generator=g, device=DEV, dtype=torch.int32)
        return torch.where(c >= 1 << (n - 1), c + 1, c)
    c = codec_ops.encode(torch.randn(shape, generator=g, device=DEV) * scale, fmt.es,
                         nbits=n).to(torch.int32)
    if kind == "minmax":
        big, tiny = (1 << (n - 1)) - 1, 1
        edge = torch.tensor([big, tiny, (1 << n) - big, (1 << n) - tiny], dtype=torch.int32,
                            device=DEV)
        c[0, :4] = edge
        c[:4, 0] = edge.flip(0)
    return c


def make_quire_inputs(M, K, N, a_fmt, b_fmt, bias, residual, seed=0, kind="gauss"):
    """Activation and weight codes as the quire linear makes them (or of a
    wide span, ``kind``), plus a NaR in the last row of A (its outputs must
    read out NaR)."""
    g = gen(seed)
    a = _quire_codes(g, (M, K), a_fmt, kind)
    a[M - 1, K // 3] = 1 << (a_fmt.nbits - 1)
    a = a.to(a_fmt.storage_dtype)
    b = _quire_codes(g, (K, N), b_fmt, kind, scale=K ** -0.5).to(b_fmt.storage_dtype)
    bi = torch.randn((N,), generator=g, device=DEV) * 0.1 if bias else None
    r = torch.randn((M, N), generator=g, device=DEV) if residual else None
    return a, b, bi, r


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32)


def check_quire_gemm() -> dict:
    """Bit for bit against the plain version on two 128-column slices of N
    (first and last, at full M and K: the plain version's int64 digit
    tensors grow with M*N), and the whole result against the same kernel
    with split-K forced to 1. Reports the share of products that took the
    kernel's per-product branch (the window rule of ref.py), asserted above
    0 in the wide-span cases whose formats span more than the window.
    Returns the largest difference measured over the compared slices:
    |value| (posit outputs decoded) and code ulps."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.kernels.posit_quire_gemm.ref import per_product_share
    rows = []
    worst_abs, worst_ulp = 0.0, 0
    for name, M, K, N, a_fmt, b_fmt, out_fmt, bias, act, res, kind in quire_cases():
        a, b, bi, r = make_quire_inputs(M, K, N, a_fmt, b_fmt, bias, res, kind=kind)
        es = (a_fmt.es, b_fmt.es, getattr(out_fmt, "es", 0))
        kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt, activation=act)
        got = posit_quire_gemm(a, b, es, bias=bi, residual=r, **kw)
        one = posit_quire_gemm(a, b, es, bias=bi, residual=r, splits=1, **kw)
        assert torch.equal(_as_bits(got), _as_bits(one)), f"quire {name}: split-K changed bits"
        mismatches, case_abs, case_ulp = 0, 0.0, 0
        for cols in (slice(0, min(N, 128)), slice(max(0, N - 128), N)):
            want = posit_quire_gemm_ref(a, b[:, cols].contiguous(), es,
                                        bias=None if bi is None else bi[cols],
                                        residual=None if r is None else r[:, cols].contiguous(),
                                        **kw)
            part = got[:, cols]
            mismatches += int((_as_bits(part) != _as_bits(want)).sum())
            if out_fmt == F32:
                case_abs = max(case_abs, max_abs_diff(part, want))
            else:
                n = out_fmt.nbits
                d = (part.to(torch.int32) - want.to(torch.int32)) & ((1 << n) - 1)
                case_ulp = max(case_ulp, int(torch.minimum(d, (1 << n) - d).max()))
                case_abs = max(case_abs, max_abs_diff(
                    codec_ref.decode_ref(part.contiguous(), out_fmt.es, nbits=n),
                    codec_ref.decode_ref(want, out_fmt.es, nbits=n)))
        assert mismatches == 0, f"quire {name}: {mismatches} outputs differ from the plain version"
        nar = got[M - 1].isnan().all() if out_fmt == F32 else \
            (got[M - 1].to(torch.int32) == 1 << (out_fmt.nbits - 1)).all()
        assert bool(nar), f"quire {name}: a NaR operand must make its row NaR"
        count, share = per_product_share(a, b, es, a_fmt=a_fmt, b_fmt=b_fmt)
        if kind != "gauss" and (spans_window(a_fmt) or spans_window(b_fmt)):
            assert count > 0, f"quire {name}: no product took the per-product branch"
        rows.append({"case": name, "kind": kind, "mismatches": mismatches,
                     "split_k_equal": True, "max_abs_err": case_abs,
                     "max_code_ulps": case_ulp, "per_product_products": count,
                     "per_product_share": share})
        worst_abs, worst_ulp = max(worst_abs, case_abs), max(worst_ulp, case_ulp)
        del a, b, bi, r, got, one
    torch.cuda.empty_cache()
    DETAILS["quire_checks"] = rows
    return {"cases": len(rows), "mismatches": 0, "max_abs_err": worst_abs,
            "max_code_ulps": worst_ulp,
            "per_product_share": {r["case"]: r["per_product_share"] for r in rows}}


# --------------------------------------------------------------- phase 4 ----

def attn_inputs(kv_bits, *, B=4, Hq=40, Hkv=8, d=128, S=512, lengths=(0, 1, 300, 512),
                seed=0, es=0):
    g = gen(seed)
    q = torch.randn((B, Hq, d), generator=g, device=DEV)
    k = torch.randn((B, Hkv, S, d), generator=g, device=DEV)
    v = torch.randn((B, Hkv, S, d), generator=g, device=DEV)
    if kv_bits:
        k = codec_ops.encode(k, es, nbits=kv_bits)
        v = codec_ops.encode(v, es, nbits=kv_bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return q, k, v, lens


# (name, kv_bits, es, Hq, Hkv, d, S, lengths) of phase 4's kernel checks:
# qwen2.5-14b's heads (40/8, d 128), phi3-mini-3.8b's (32/32, d 96),
# head_dim 256 at 7 q-heads a KV head and at gemma3-4b's 2 (8/4, S 1,600,
# its global layers' S_max) and whisper-medium's cross read (16/16, d 64,
# S 1,500, no append); ragged rows (0, 1, mid, S)
ATTN_CHECKS = (
    ("qwen p8 S512", 8, 0, 40, 8, 128, 512, (0, 1, 300, 512)),
    ("qwen p16 S512", 16, 0, 40, 8, 128, 512, (0, 1, 300, 512)),
    ("qwen f32 S512", 0, 0, 40, 8, 128, 512, (0, 1, 300, 512)),
    ("qwen p8 S4096", 8, 0, 40, 8, 128, 4096, (0, 1, 2051, 4096)),
    ("phi3 p16_1 d96 S4096", 16, 1, 32, 32, 96, 4096, (0, 1, 2051, 4096)),
    ("d256 7 q-heads p8 S4096", 8, 0, 28, 4, 256, 4096, (0, 1, 2051, 4096)),
    ("d256 7 q-heads f32 S1000", 0, 0, 28, 4, 256, 1000, (0, 1, 513, 1000)),
    ("gemma3 p8 d256 S1600", 8, 0, 8, 4, 256, 1600, (0, 1, 801, 1600)),
    # whisper-medium's cross read: 16/16 heads, d 64, the 1,500 encoder rows
    ("whisper cross p8 d64 S1500", 8, 0, 16, 16, 64, 1500, (0, 1, 751, 1500)),
)


# (name, kv_bits, Hq, Hkv, d, S, lengths, pos) of the fused append's checks
# (the decode step's call): qwen2.5-14b's heads, a row at pos >= S
# untouched, whisper-medium's self-attention (16/16, d 64) at ragged
# positions, and gemma3-4b's heads (8/4, d 256): a global layer's append at
# S_max 1,600 and a local layer's rolling append over a full window (S = W
# = 1,024, len W) at sequence positions 1,536-1,599, so the row lands inside
# the buffer (pos = lens % W)
APPEND_CHECKS = (
    ("append p8 S80", 8, 40, 8, 128, 80, (3, 80, 80, 0), (2, 80, 79, 0)),
    ("append p8 S4096", 8, 40, 8, 128, 4096, (3, 4096, 4096, 0), (2, 4096, 4095, 0)),
    ("append p16 S4096", 16, 40, 8, 128, 4096, (3, 4096, 4096, 0), (2, 4096, 4095, 0)),
    ("whisper self append p8 d64 S64", 8, 16, 16, 64, 64, (3, 64, 33, 1), (2, 64, 32, 0)),
    ("gemma3 global append p8 d256 S1600", 8, 8, 4, 256, 1600, (1537, 1558, 1581, 1600),
     (1536, 1557, 1580, 1599)),
    ("gemma3 local rolling append p8 d256 S1024", 8, 8, 4, 256, 1024, (1024,) * 4,
     tuple(p % 1024 for p in (1536, 1557, 1580, 1599))),
)


# The tight limit: 64 u max|V|, the contract's bound without its length term.
# The kernel keeps f32 accuracy (q and P in three bf16 pieces); its error is
# ~1e-6 at max|V| ~4 in every phase-4 case, and one bf16 piece for P (or for
# q and P) gives 2^-9-sized errors, ~1e-4 and more, on the same inputs.
TIGHT_ULPS = 64


def attention_bf16_control(q, k, v, lens, es, kv_bits, *, q_bf16: bool) -> torch.Tensor:
    """The kernel's arithmetic with P (and q when ``q_bf16``) as one bf16
    piece instead of three, in f64 otherwise: the control the limits must
    reject. P is rounded before the PV product; the softmax sum stays exact,
    as the kernel keeps it in f32."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k.shape
    kv, vv = ((codec_ref.decode_ref(t, es, nbits=kv_bits) if kv_bits else t).double()
              for t in (k, v))
    qd = (q.bfloat16() if q_bf16 else q).double().reshape(B, Hkv, Hq // Hkv, d)
    valid = (torch.arange(S, device=q.device)[None] < lens[:, None])[:, None, None]
    s = torch.where(valid, torch.einsum("bkgd,bksd->bkgs", qd, kv) / d ** 0.5, -1e300)
    e = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = e.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", e.float().bfloat16().double(),
                       torch.where(valid[:, :, 0, :, None], vv, 0.0))
    return (out / torch.where(l == 0, 1.0, l)).reshape(B, Hq, d).float()


def attention_case_errors(name, got, q, k, v, lens, es, kv_bits, d, S) -> dict:
    """The kernel's error on a case against the contract's limit and the
    tight one, beside the bf16 controls' errors; raises if the kernel fails
    either limit or the tight limit passes a control."""
    want = posit_decode_attention_ref(q, k, v, lens, es, kv_bits=kv_bits)
    vmax = float((codec_ref.decode_ref(v, es, nbits=kv_bits) if kv_bits else v).abs().max())
    row = {"case": name, "max_abs_err": float((got - want).abs().max()),
           "limit": 4 * (d + 2 * S) * U * vmax, "tight_limit": TIGHT_ULPS * U * vmax}
    for key, q_bf16 in (("bf16_p_err", False), ("bf16_qp_err", True)):
        ctl = attention_bf16_control(q, k, v, lens, es, kv_bits, q_bf16=q_bf16)
        row[key] = float((ctl - want).abs().max())
        assert row[key] > row["tight_limit"], \
            f"attention {name}: the tight limit passes the {key[:-4]} control ({row}"
    assert row["max_abs_err"] <= row["limit"], f"attention {name}: {row}"
    assert row["max_abs_err"] <= row["tight_limit"], f"attention {name}: {row}"
    return row


def check_attention() -> dict:
    """The kernel against its plain version on every ATTN_CHECKS case and on
    the fused append's, within 4 * (d + 2S) * u * max|V| (f32 throughout; the
    score dot, the softmax sum and the PV sum run in other orders) and within
    the tight limit, which the bf16 controls must fail; at S = 80 a bf16 P
    must fail the contract's limit as well (why P and q take three pieces).
    Length-0 rows exact zeros; the fused append (the decode step's call) on
    every APPEND_CHECKS case: its cache codes bit for bit those of the encode kernel +
    the row write, a row at pos >= S untouched, its output bit for bit the
    unfused kernel's on the written cache; each row's bits alone and inside
    the batch; the CPU emulation's warps a block those of the kernel."""
    rows = []
    for name, kv_bits, es, Hq, Hkv, d, S, lengths in ATTN_CHECKS:
        q, k, v, lens = attn_inputs(kv_bits, Hq=Hq, Hkv=Hkv, d=d, S=S, lengths=lengths,
                                    seed=S + d, es=es)
        got = attn_ops.decode_attention(q, k, v, lens, es, kv_bits=kv_bits)
        rows.append(attention_case_errors(name, got, q, k, v, lens, es, kv_bits, d, S))
        assert bool((got[0] == 0).all()), f"attention {name}: a length-0 row must be zeros"
        assert attn_ref.kernel_warps(d, k.element_size(), kv_bits) == \
            attn_ops.kernel_warps(kv_bits, k.dtype, d), f"attention {name}: warps a block"
        del q, k, v, got
    appended = []
    for name, kv_bits, Hq, Hkv, d, S, lengths, at in APPEND_CHECKS:
        q, k, v, lens = attn_inputs(kv_bits, Hq=Hq, Hkv=Hkv, d=d, S=S, lengths=lengths,
                                    seed=S + kv_bits)
        pos = torch.tensor(at, dtype=torch.int32, device=DEV)
        kn, vn = (torch.randn((4, Hkv, d), generator=gen(S + i), device=DEV)
                  for i in range(2))
        k_want, v_want = k.clone(), v.clone()
        for cache, new in ((k_want, kn), (v_want, vn)):  # the encode kernel, the row write
            attn_ref.store_row(cache, codec_ops.encode(new, 0, nbits=kv_bits), pos, 0,
                               kv_bits=0)
        got = attn_ops.decode_attention_append(q, kn, vn, k, v, pos, lens, 0, kv_bits=kv_bits)
        assert torch.equal(k, k_want) and torch.equal(v, v_want), \
            f"{name}: cache codes differ from encode + the row write"
        unfused = attn_ops.decode_attention(q, k_want, v_want, lens, 0, kv_bits=kv_bits)
        assert torch.equal(bits(got), bits(unfused)), \
            f"{name}: output differs from the unfused kernel's bits"
        for b in range(4):
            alone = attn_ops.decode_attention(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                                              v[b:b + 1].contiguous(), lens[b:b + 1], 0,
                                              kv_bits=kv_bits)
            assert torch.equal(bits(alone[0]), bits(unfused[b])), \
                f"{name}: row {b} alone differs from row {b} in the batch"
        row = attention_case_errors(name, got, q, k, v, lens, 0, kv_bits, d, S)
        if S == 80:
            assert row["bf16_p_err"] > row["limit"], \
                f"{name}: a bf16 P holds the contract's limit ({row})"
        rows.append(row)
        appended.append(name)
        del q, k, v, k_want, v_want
    torch.cuda.empty_cache()
    DETAILS["attention_checks"] = rows
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "cases": [r["case"] for r in rows],
            "min_control_over_tight": min(r["bf16_p_err"] / r["tight_limit"] for r in rows),
            "append_bit_exact": appended, "batch_invariant": appended}


def nar_full(shape, dtype) -> torch.Tensor:
    """A code array of ``shape`` (uint8 or uint16) holding NaR everywhere."""
    if dtype == torch.uint16:
        return torch.full(shape, -32768, dtype=torch.int16, device=DEV).view(torch.uint16)
    return torch.full(shape, 0x80, dtype=torch.uint8, device=DEV)


def code_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def page_cache(k, v, lengths, bt: int, *, seed: int, extra: int = 8):
    """Dense K/V codes (B, Hkv, S, d) as pools (N, Hkv, bt, d) and a block
    table (B, W), W * bt = S, as a paged engine leaves them: row b's first
    ceil(len / bt) pages at shuffled, non-contiguous block ids, the rest of
    its entries sentinels (N, and N + 7 on odd rows: any id >= N is empty);
    every pool row starts as NaR, as a recycled page may hold, so the rows
    past each length in a row's last page and the ``extra`` unused blocks
    are NaR."""
    B, Hkv, S, d = k.shape
    W = S // bt
    N = B * W + extra
    ids = torch.randperm(N, generator=torch.Generator().manual_seed(seed))[:B * W]
    table = ids.reshape(B, W).to(torch.int32)
    pools = []
    for t in (k, v):
        t = t.clone()
        pool = nar_full((N, Hkv, bt, d), t.dtype)
        for b, n in enumerate(lengths):
            code_bits(t)[b, :, n:] = code_bits(nar_full((1,), t.dtype))
        pages = t.reshape(B, Hkv, W, bt, d).permute(0, 2, 1, 3, 4)
        for b, n in enumerate(lengths):
            used = -(-n // bt)
            code_bits(pool)[table[b, :used].long().to(DEV)] = \
                code_bits(pages[b, :used].contiguous())
        pools.append(pool)
    for b, n in enumerate(lengths):
        table[b, -(-n // bt):] = N + 7 * (b % 2)
    return pools[0], pools[1], table.to(DEV)


def live_codes(codes: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Dense codes with every position at or past its row's length set to
    code 0: the plain version's output is the same (those positions are
    masked), and max|V| is over live values, not stale NaR."""
    S = codes.shape[2]
    keep = (torch.arange(S, device=DEV)[None] < lens[:, None])[:, None, :, None]
    return torch.where(keep, code_bits(codes), torch.zeros((), dtype=code_bits(codes).dtype,
                                                          device=DEV)).view(codes.dtype)


# the paged path's requests, pages and S_max (run_paged_path)
PAGED_REQUESTS, PAGED_PROMPT, PAGED_GEN, PAGED_OVERLAP = 16, 1024, 32, 0.9
PAGED_PAGE_BYTES = 32768
PAGED_S_MAX = PAGED_PROMPT + PAGED_GEN

# (kv_bits, bt, S = W * bt, lengths) of phase 4's paged cases, at qwen2.5-14b's
# heads: S = 4,096 at bt 1, 16 and 32; and the paged path's own 4-slot shape,
# W 66 pages of 16 (S_max 1,056), lengths about its decode steps'
PAGED_LENGTHS = (0, 1, 300, 4096)
PAGED_CHECKS = tuple((kv_bits, bt, 4096, PAGED_LENGTHS) for kv_bits in (8, 16)
                     for bt in (1, 16, 32)) + \
    ((8, 16, PAGED_S_MAX, (0, PAGED_PROMPT, PAGED_PROMPT + 17, PAGED_S_MAX)),)


def check_paged_attention() -> dict:
    """The paged mode of the attention kernel at qwen2.5-14b's heads, p8 and
    p16, bt 1, 16 and 32, lengths 0, 1, 300 and 4,096, and at the paged
    path's 4-slot shape (W 66, bt 16; PAGED_CHECKS), over
    ``page_cache``'s shuffled pools with sentinel tails and NaR-filled
    recycled pages: the output bit for bit the dense kernel's on the
    de-paged cache (``ref.depage``), within the contract's limit and the
    tight one of the plain version (``attention_case_errors``, on the live
    codes, and the paged plain version itself within the tight limit), a
    length-0 row exact zeros. The paged append (bt 16, p8 and p16): the
    pools' codes bit for bit those of the encode kernel + the paged row
    write (``ref.store_row_paged``), a write past W * bt and one through a
    sentinel entry dropped, its output bit for bit the unfused paged call's
    and the dense kernel's on the de-paged written cache."""
    rows = []
    for kv_bits, bt, S, lengths in PAGED_CHECKS:
        name = f"paged p{kv_bits} bt{bt} S{S}"
        q, k, v, lens = attn_inputs(kv_bits, S=S, lengths=lengths, seed=S + bt + kv_bits)
        kp, vp, table = page_cache(k, v, lengths, bt, seed=bt + kv_bits)
        del k, v
        got = attn_ops.decode_attention_paged(q, kp, vp, table, lens, 0, kv_bits=kv_bits)
        kd, vd = attn_ref.depage(kp, table), attn_ref.depage(vp, table)
        dense = attn_ops.decode_attention(q, kd, vd, lens, 0, kv_bits=kv_bits)
        assert torch.equal(bits(got), bits(dense)), \
            f"attention {name}: output differs from the dense kernel on the de-paged cache"
        assert bool((got[0] == 0).all()), f"attention {name}: a length-0 row must be zeros"
        row = attention_case_errors(name, got, q, live_codes(kd, lens), live_codes(vd, lens),
                                    lens, 0, kv_bits, QWEN.hd, S)
        plain = attn_ref.posit_decode_attention_paged_ref(q, kp, vp, table, lens, 0,
                                                          kv_bits=kv_bits)
        row["paged_plain_err"] = float((got - plain).abs().max())
        assert row["paged_plain_err"] <= row["tight_limit"], f"attention {name}: {row}"
        rows.append(row)
        del q, kp, vp, kd, vd, got, dense, plain
    appended = []
    bt, S = 16, PAGED_LENGTHS[-1]
    lengths = (3, S, 301, 0)
    for kv_bits in (8, 16):
        q, k, v, lens = attn_inputs(kv_bits, S=S, lengths=lengths, seed=S + 100 + kv_bits)
        kp, vp, table = page_cache(k, v, lengths, bt, seed=100 + kv_bits)
        table[3] = kp.shape[0]   # row 3: an inactive slot, every entry empty
        # row 0 rewrites a live position, row 1 writes past W * bt, row 2 at
        # its length, row 3 through a sentinel entry
        pos = torch.tensor([2, S, 300, 5], dtype=torch.int32, device=DEV)
        kn, vn = (torch.randn((4, QWEN.n_kv, QWEN.hd), generator=gen(S + 100 + i), device=DEV)
                  for i in range(2))
        k_want, v_want = kp.clone(), vp.clone()
        for pool, new in ((k_want, kn), (v_want, vn)):  # the encode kernel, the row write
            attn_ref.store_row_paged(pool, codec_ops.encode(new, 0, nbits=kv_bits), table, pos,
                                     0, kv_bits=0)
        got = attn_ops.decode_attention_append_paged(q, kn, vn, kp, vp, table, pos, lens, 0,
                                                     kv_bits=kv_bits)
        assert torch.equal(kp, k_want) and torch.equal(vp, v_want), \
            f"paged append p{kv_bits}: pool codes differ from encode + the paged row write"
        unfused = attn_ops.decode_attention_paged(q, k_want, v_want, table, lens, 0,
                                                  kv_bits=kv_bits)
        assert torch.equal(bits(got), bits(unfused)), \
            f"paged append p{kv_bits}: output differs from the unfused paged call's bits"
        kd, vd = attn_ref.depage(kp, table), attn_ref.depage(vp, table)
        dense = attn_ops.decode_attention(q, kd, vd, lens, 0, kv_bits=kv_bits)
        assert torch.equal(bits(got), bits(dense)), \
            f"paged append p{kv_bits}: output differs from the dense kernel's bits"
        rows.append(attention_case_errors(f"paged append p{kv_bits} bt{bt}", got, q,
                                          live_codes(kd, lens), live_codes(vd, lens), lens, 0,
                                          kv_bits, QWEN.hd, S))
        appended.append(f"p{kv_bits} bt{bt}")
        del q, k, v, kp, vp, k_want, v_want, kd, vd
    torch.cuda.empty_cache()
    DETAILS["paged_attention_checks"] = rows
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            "cases": [r["case"] for r in rows],
            "bit_exact_with_dense": [r["case"] for r in rows],
            "min_control_over_tight": min(r["bf16_p_err"] / r["tight_limit"] for r in rows),
            "append_bit_exact": appended}


def check_softmax() -> dict:
    """Within 1 posit ulp (signed code space) of the plain version: the
    paper's softmax rows and phi3's logit rows, p16_1, plus p8 cases, qwen's
    vocabulary-wide rows at p8 and p16, one- and 31-column rows, and rows
    holding a NaR code (they must come out all NaR)."""
    worst_ulp, worst_abs = 0, 0.0
    cases = ([(shape, 16, False) for shape in SOFTMAX_SHAPES] + [((64, 300), 8, False)]
             + [(QWEN_LOGITS, nbits, True) for nbits in (8, 16)]
             + [((64, 1), 16, False), ((64, 31), 8, True), ((8, 2500), 16, True)])
    for (R, C), nbits, nar in cases:
        codes = codec_ops.encode(torch.randn((R, C), generator=gen(C), device=DEV) * 3, 1,
                                 nbits=nbits)
        half, full = 1 << (nbits - 1), 1 << nbits
        if nar:
            codes = codes.to(torch.int32)
            codes[R - 1, C // 2] = half
            codes = codes.to(torch.uint8 if nbits == 8 else torch.uint16)
        got = softmax_ops.softmax(codes, 1, nbits=nbits)
        want = posit_softmax_ref(codes, 1, nbits=nbits)
        if nar:
            assert bool((got[R - 1].to(torch.int32) == half).all()), \
                f"softmax ({R}, {C}) p{nbits}: a NaR row must come out all NaR"
        sg, sw = got.to(torch.int64), want.to(torch.int64)
        ulp = int((torch.where(sg >= half, sg - full, sg)
                   - torch.where(sw >= half, sw - full, sw)).abs().max())
        assert ulp <= 1, f"softmax ({R}, {C}) p{nbits}: {ulp} posit ulps apart"
        err = max_abs_diff(codec_ref.decode_ref(got, 1, nbits=nbits),
                           codec_ref.decode_ref(want, 1, nbits=nbits))
        worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, err)
    return {"cases": len(cases), "max_code_ulps": worst_ulp, "max_abs_err": worst_abs}


# --------------------------------------------------------------- phase 5 ----

def check_small_model(arch=QWEN, policy=P8_SERVE, bound: float = 0.05,
                      prompt_len: int = 16, layers: int = 0) -> dict:
    """A reduced model (``layers`` deep where given): the card's kernels
    against the CPU's plain versions, same seed-made weights, prefill + 4
    greedy decode steps, and every KV stack's lengths equal. Bounds: P8_SERVE
    rounds activations to bf16 and K/V to p8, where one flipped rounding
    moves logits ~1e-2 (0.05), and so do the per-layer presets p8-packed
    (bf16 compute) and attn-p16-mlp-p8 (p16 and packed-p8 weights, 0.05);
    under the quire every linear is exact, but f32 norms, attention and silu
    in another order can move a p16 activation or K/V code by one ulp
    (2^-13), ~1e-3 on a logit (2e-3). A prompt past LARGE_M tokens (2 x
    300) runs every prefill linear on the large-M kernels (asserted)."""
    cfg = arch.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params_cpu = cpu_model.init(0, policy)
    params_gpu = _to(params_cpu, DEV)
    toks = torch.randint(0, cfg.vocab, (2, prompt_len),
                         generator=torch.Generator().manual_seed(0), dtype=torch.int32)
    lc, cc = cpu_model.prefill(params_cpu, toks, policy, S_max=prompt_len + 8)
    before = dict(kernels.LAUNCHES)
    lg, cg = gpu_model.prefill(params_gpu, toks.to(DEV), policy, S_max=prompt_len + 8)
    large = {k: kernels.LAUNCHES[k] - before[k]
             for k in ("posit_gemm_large_tc", "posit_gemm_large_fma")}
    if 2 * prompt_len > gemm_ops.LARGE_M:
        assert sum(large.values()) > 0, "a long prefill left the large-M kernels"
    worst, agree, clear = 0.0, 0, 0
    for _ in range(5):
        err = float((lg.cpu() - lc).abs().max())
        worst = max(worst, err)
        assert torch.isfinite(lg).all() and err <= bound, f"reduced model: logits off by {err}"
        top2 = torch.topk(lc, 2, dim=-1).values
        margin_clear = (top2[:, 0] - top2[:, 1]) > 2 * bound
        same = lg.cpu().argmax(-1) == lc.argmax(-1)
        assert bool(same[margin_clear].all()), "greedy tokens differ on a margin-clear step"
        agree += int(same.sum())
        clear += int(margin_clear.sum())
        tok = lc.argmax(-1).to(torch.int32)
        lc, cc = cpu_model.decode_step(params_cpu, tok, cc, policy)
        lg, cg = gpu_model.decode_step(params_gpu, tok.to(DEV), cg, policy)
    assert torch.equal(cg["lens"].cpu(), cc["lens"]), "reduced model: lens differ"
    for name in ("kv", "kv_local"):
        if name in cc:
            assert torch.equal(cg[name]["len"].cpu(), cc[name]["len"]), \
                f"reduced model: {name} lengths differ"
    return {"arch": cfg.name, "policy": policy.describe(), "prompt": [2, prompt_len],
            "max_logit_err": worst, "bound": bound, "greedy_agree": agree,
            "margin_clear": clear, "prefill_large_m_launches": large}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


P8_PATH_KERNELS = ("posit_decode", "posit_encode", "posit_gemm", "posit_attention")


def run_main_path() -> tuple[dict, dict]:
    events = []
    kernels.reset_launches()
    report = serve("qwen2.5-14b", policy="p8-serve", max_slots=4, requests=8, prompt_len=64,
                   gen=16, seed=0, device="cuda", emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the 64-token prefills' linears (M = 64) run on the mid-M kernel
    # (kernel_timings.py serves this path with older packages too)
    for name in P8_PATH_KERNELS + tuple(k for k in ("posit_gemm_mid_tc",) if k in launches):
        assert launches[name] > 0, f"kernel {name} was not launched on the main path"
    assert report["requests"] == 8, report["requests"]
    assert all(n == 16 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the main path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV cache"
    DETAILS["serve_events"] = events
    return report, launches


LONG_PROMPT, LONG_GEN = 4032, 64   # the long-context path: S_max 4,096


def run_long_path() -> tuple[dict, dict]:
    """qwen2.5-14b at full width and depth, P8_SERVE, 4 requests of 4,032
    prompt tokens and 64 generated, 4 slots, greedy, S_max 4,096: decode
    attention over caches of ~4,000 positions (1.6 GB of p8 K/V)."""
    events = []
    kernels.reset_launches()
    report = serve("qwen2.5-14b", policy="p8-serve", max_slots=4, requests=4,
                   prompt_len=LONG_PROMPT, gen=LONG_GEN, seed=0, device="cuda",
                   emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the 4,032-token prefills on the wgmma kernel, the decode steps on the
    # rest (kernel_timings.py runs this path on packages from before it too)
    for name in P8_PATH_KERNELS + tuple(k for k in ("posit_gemm_large_tc",) if k in launches):
        assert launches[name] > 0, f"kernel {name} was not launched on the long path"
    assert report["requests"] == 4, report["requests"]
    assert all(n == LONG_GEN for n in report["completion_tokens"].values()), \
        report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the long path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV cache"
    DETAILS["long_serve_events"] = events
    return report, launches


def run_mixed_path() -> tuple[dict, dict]:
    """qwen2.5-14b at full width and depth under ``--policy p8-serve
    --precision-policy attn-p16-mlp-p8``: the attention projections at p16
    on the tensor-core kernel's p16 route, the MLP and lm_head in packed p8
    lanes on the packed tensor-core variant, K/V at p8. Neither f32-FMA
    route (unpacked or packed) may launch."""
    events = []
    kernels.reset_launches()
    report = serve("qwen2.5-14b", policy="p8-serve", precision_policy=MIXED, max_slots=4,
                   requests=8, prompt_len=64, gen=16, seed=0, device="cuda",
                   emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in ("posit_gemm_p16", "posit_gemm_packed", "posit_encode", "posit_attention"):
        assert launches[name] > 0, f"kernel {name} was not launched on the mixed path"
    assert launches["posit_gemm_packed_fma"] == 0, "the packed FMA variant ran on bf16 compute"
    assert launches["posit_gemm"] == 0, "a p16 projection left the tensor cores"
    assert report["requests"] == 8, report["requests"]
    assert all(n == 16 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the mixed path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV cache"
    # attention at 2 bytes a weight, MLP and head at 1, against 4 in f32
    c = QWEN
    attn_n = c.d_model * (2 * c.n_heads * c.hd + 2 * c.n_kv * c.hd)
    mlp_n = 3 * c.d_model * c.d_ff
    want = c.n_layers * (2 * attn_n + mlp_n) + c.d_model * c.vocab
    assert report["weight_bytes_policy"] == want, (report["weight_bytes_policy"], want)
    DETAILS["mixed_serve_events"] = events
    return report, launches


def run_mixed_fma_path() -> tuple[dict, dict]:
    """qwen2.5-14b at full width and depth under ``--policy none
    --precision-policy attn-p16-mlp-p8`` (f32 compute, f32 KV cache): the
    packed lanes on the packed f32-FMA variant and the p16 projections on the
    f32-FMA kernels, the tensor-core routes idle."""
    events = []
    kernels.reset_launches()
    report = serve("qwen2.5-14b", policy="none", precision_policy=MIXED, max_slots=4,
                   requests=4, prompt_len=32, gen=8, seed=0, device="cuda",
                   emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in ("posit_gemm", "posit_gemm_packed_fma", "posit_attention"):
        assert launches[name] > 0, f"kernel {name} was not launched on the mixed f32 path"
    assert launches["posit_gemm_packed"] == 0, "the packed tensor-core variant ran on f32"
    assert launches["posit_gemm_p16"] == 0, "the p16 tensor-core route ran on f32"
    assert report["requests"] == 4, report["requests"]
    assert all(n == 8 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the mixed f32 path"
    DETAILS["mixed_fma_serve_events"] = events
    return report, launches


def run_quire_path() -> tuple[dict, dict]:
    """phi3-mini-3.8b at full width and depth under the quire: every
    posit-coded linear must leave the fused GEMM for the quire GEMM."""
    events = []
    kernels.reset_launches()
    report = serve("phi3-mini-3.8b", policy=QUIRE_SPEC, max_slots=4, requests=4, prompt_len=32,
                   gen=8, seed=0, device="cuda", emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in ("posit_quire_gemm", "posit_encode", "posit_attention"):
        assert launches[name] > 0, f"kernel {name} was not launched on the quire path"
    assert launches["posit_gemm"] == 0, "a posit-coded linear left the quire"
    assert report["requests"] == 4, report["requests"]
    assert all(n == 8 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the quire path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV cache"
    DETAILS["quire_serve_events"] = events
    return report, launches


def run_softmax_path() -> tuple[dict, dict]:
    """The softmax entry point (core.dot.posit_softmax, the paper's section
    IV-C benchmark) on its rows and on phi3's logit rows, p16_1."""
    kernels.reset_launches()
    rows = []
    for R, C in SOFTMAX_SHAPES:
        codes = codec_ops.encode(torch.randn((R, C), generator=gen(R + C), device=DEV) * 3, 1,
                                 nbits=16)
        y = posit_softmax(codes, P16_1)
        total = codec_ref.decode_ref(y, 1, nbits=16).sum(-1)
        assert y.shape == (R, C) and bool(((total - 1).abs() < 0.05).all()), \
            f"softmax ({R}, {C}): rows do not sum to 1"
        rows.append({"R": R, "C": C, "max_row_sum_err": float((total - 1).abs().max())})
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert launches["posit_softmax"] == len(SOFTMAX_SHAPES), launches
    return {"rows": rows}, launches


# the paged path: qwen2.5-14b P8_SERVE, 16 requests of 1,024 prompt tokens at
# 90% overlap (bench_prefix_cache._requests), 32 generated each, pages of
# 32,768 B (16 tokens of 8 KV heads x 128 at p8), S_max 1,056


def prefix_requests(n: int, prompt_len: int, overlap: float, gen: int, vocab: int,
                    seed: int = 0) -> list:
    """``n`` requests as benchmarks/bench_prefix_cache.py ``_requests`` builds
    them at rate 0: a shared head of round(overlap * prompt_len) tokens from
    a fixed draw (seed 1234), unique tails from ``seed``, all at t = 0."""
    rng = np.random.default_rng(1234)
    n_shared = int(round(overlap * prompt_len))
    shared = rng.integers(0, vocab, size=n_shared)
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, size=prompt_len - n_shared)]).astype(np.int32),
        max_new_tokens=gen) for i in range(n)]


def serve_recorded_timed(eng, reqs) -> dict:
    """``eng.run(reqs)`` with every sampled logits row kept (a prefill's row,
    and each decode step's active rows) and the decode steps timed apart
    (``decode_tok_per_s``: tokens the steps emit over the seconds spent in
    them, host and device, as bench_prefix_cache.py measures decode);
    ``tok_per_s``: every token over the run's wall time, prefill included.
    For a paged engine the peak of live blocks after any admission or step."""
    seen, sample, step = [], eng._next_token, eng.step
    timed = {"s": 0.0, "emitted": 0, "live": 0}
    paged = hasattr(eng, "manager")

    def recording(logits):
        if logits.shape[0] == eng.max_slots:
            idx = torch.from_numpy(np.nonzero(eng.active)[0]).to(logits.device)
            seen.append(logits.index_select(0, idx).clone())
        else:
            seen.append(logits.clone())
        if paged:
            timed["live"] = max(timed["live"], eng.manager.stats()["live"])
        return sample(logits)

    def timed_step(now=0.0):
        t0 = time.perf_counter()
        n = step(now)
        timed["s"] += time.perf_counter() - t0
        timed["emitted"] += n
        return n

    eng._next_token, eng.step = recording, timed_step
    t0 = time.perf_counter()
    try:
        done = eng.run(reqs)
    finally:
        del eng._next_token, eng.step   # the class's methods again, no cycle
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_tok = [t for c in done for t in c.per_token_s()[1:]]
    out = {"tokens": {c.rid: c.tokens for c in done}, "seen": seen,
           "reasons": sorted({c.finish_reason for c in done}), "decode_steps": eng.steps,
           "decode_tok_per_s": timed["emitted"] / timed["s"],
           "tok_per_s": sum(len(c.tokens) for c in done) / wall, "wall_s": wall,
           "p50_token_ms": float(np.percentile(per_tok, 50) * 1e3),
           "p50_ttft_ms": float(np.percentile([c.ttft_s for c in done], 50) * 1e3),
           "kv_bytes_allocated": sum(t.numel() * t.element_size()
                                     for t in (eng.cache["kv"]["k"], eng.cache["kv"]["v"]))}
    if paged:
        out["kv_bytes_peak_live"] = eng.geom.pool_bytes(timed["live"])
        out["peak_live_blocks"] = timed["live"]
        out["prefix_cache"] = eng.prefix_stats()
        out["n_blocks"] = eng.n_blocks
    else:
        out["kv_bytes_peak_live"] = out["kv_bytes_allocated"]
    return out


def run_paged_path() -> tuple[dict, dict]:
    """qwen2.5-14b at full width and depth, P8_SERVE, random weights from
    seed 0: the PAGED_REQUESTS prefix-sharing requests served four ways, the
    slot grid at 4 slots, the paged engine at 4 slots (the default pool: the
    4-slot grid's bytes, 264 blocks of 16 tokens), the grid at 16 slots and
    the paged engine at 16 slots on those 264 blocks. Paged and grid give
    the same tokens and every sampled logits row bit for bit at 4 and at 16
    slots; each paged run has 15 prefix hits of 912 tokens; at 16 slots all
    16 are admitted at once (one wave of 31 steps) and none ends
    ``cache_full``; no paged run launches the dense attention kernel, its
    decode steps 48 paged launches each, and its only encodes are the
    prefills' K/V blocks. At 16 slots every decode step launches the mid-M
    GEMM 337 times and the 64-row tile never. Then a fork of a live request
    streams as the request alone, through copy-on-write."""
    from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine as Paged

    model = build_model(QWEN)
    params = model.init(0, P8_SERVE)
    reqs = lambda: prefix_requests(PAGED_REQUESTS, PAGED_PROMPT, PAGED_OVERLAP,  # noqa: E731
                                   PAGED_GEN, QWEN.vocab)
    n_hit = PAGED_REQUESTS - 1
    bt = PAGED_PAGE_BYTES // (2 * QWEN.n_kv * QWEN.hd)   # 16
    hit_tokens = int(round(PAGED_OVERLAP * PAGED_PROMPT)) // bt * bt   # 57 full blocks
    kernels.reset_launches()
    runs, n_blocks = {}, None
    for name, cls, slots in (("grid4", ContinuousBatchingEngine, 4), ("paged4", Paged, 4),
                             ("grid16", ContinuousBatchingEngine, 16), ("paged16", Paged, 16)):
        kw = {} if cls is ContinuousBatchingEngine else {"page_bytes": PAGED_PAGE_BYTES,
                                                          "n_blocks": n_blocks}
        eng = cls(model, params, P8_SERVE, max_slots=slots, S_max=PAGED_S_MAX, **kw)
        before = dict(kernels.LAUNCHES)
        res = serve_recorded_timed(eng, reqs())
        res["launches"] = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        res["captured"] = type(eng._decode).__name__ == "CapturedStep"
        assert res["captured"], f"paged path {name}: the decode step was not captured"
        # the 1,024-token prefills (a prefix hit prefills its whole prompt too): wgmma
        assert res["launches"].get("posit_gemm_large_tc", 1) > 0, \
            f"paged path {name}: {res['launches']}"
        assert res["reasons"] == ["max_new"], f"paged path {name}: {res['reasons']}"
        if cls is Paged:
            n_blocks = eng.n_blocks
            st = res["prefix_cache"]
            assert (st["hits"], st["hit_tokens"]) == (n_hit, n_hit * hit_tokens), st
            la = res["launches"]
            assert la["posit_attention"] == 0, f"paged path {name}: dense attention launched"
            assert la["posit_attention_paged"] == res["decode_steps"] * QWEN.n_layers, la
            assert la["posit_encode"] == PAGED_REQUESTS * 2 * QWEN.n_layers, la
        if slots == 16 and "posit_gemm_mid_tc" in kernels.LAUNCHES:
            # every decode step's 337 linears (7 a layer and lm_head, M = 16)
            # on the mid-M kernel; the only other GEMM launches are the
            # prefills' last-row lm_head (M = 1, the decode tile), one a
            # request: no 64-row tile
            la = res["launches"]
            assert la["posit_gemm_mid_tc"] == res["decode_steps"] * (7 * QWEN.n_layers + 1), \
                (name, la, res["decode_steps"])
            assert la["posit_gemm"] == PAGED_REQUESTS, (name, la)
        if name == "paged16":
            fork = fork_streams(eng, reqs()[0], res["tokens"][0])
        runs[name] = res
        del eng
        torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    assert runs["paged4"]["n_blocks"] == 4 * -(-PAGED_S_MAX // bt), runs["paged4"]["n_blocks"]
    assert runs["paged16"]["decode_steps"] == PAGED_GEN - 1, \
        f"paged path: 16 slots took {runs['paged16']['decode_steps']} steps, not one wave"
    for slots in (4, 16):
        g, p = runs[f"grid{slots}"], runs[f"paged{slots}"]
        assert p["tokens"] == g["tokens"], f"paged path: tokens differ from the grid at {slots}"
        assert_bit_identical(p["seen"], g["seen"], f"paged against grid at {slots} slots")
    keys = ("decode_steps", "decode_tok_per_s", "tok_per_s", "wall_s", "p50_token_ms",
            "p50_ttft_ms", "kv_bytes_allocated", "kv_bytes_peak_live")
    report = {name: {k: r[k] for k in keys + ("prefix_cache", "peak_live_blocks", "n_blocks")
                     if k in r} for name, r in runs.items()}
    report.update(bit_identical={"4": len(runs["paged4"]["seen"]),
                                 "16": len(runs["paged16"]["seen"])},
                  prefix_hits=n_hit, hit_tokens_each=hit_tokens,
                  admitted_at_once_16=PAGED_REQUESTS, fork=fork,
                  run_launches={n: r["launches"] for n, r in runs.items()})
    del params, model, runs
    torch.cuda.empty_cache()
    return report, launches


def fork_streams(eng, req, alone: list) -> dict:
    """``req`` served alone on a reset engine, forked after two decode steps:
    both streams equal to each other and to ``alone``, with at least one
    copy-on-write."""
    eng.reset()
    eng.submit(req)
    eng.admit()
    eng.step()
    eng.step()
    eng.fork(req.rid, 1000)
    while eng.active.any():
        eng.step()
    torch.cuda.synchronize()
    got = {c.rid: c.tokens for c in eng.completions}
    assert got[req.rid] == got[1000] == alone, "fork: the two greedy streams differ"
    cow = eng.prefix_stats()["cow_copies"]
    assert cow >= 1, "fork: no copy-on-write"
    return {"streams_equal": True, "tokens": len(alone), "cow_copies": cow}


def run_paged_serve() -> tuple[dict, dict]:
    """The paged engine through the entry point: ``serve(paged=True,
    page_bytes=32768)``, qwen2.5-14b P8_SERVE, 8 requests (prompt 64, gen
    16, 4 slots)."""
    events = []
    kernels.reset_launches()
    report = serve("qwen2.5-14b", policy="p8-serve", max_slots=4, requests=8, prompt_len=64,
                   gen=16, seed=0, paged=True, page_bytes=PAGED_PAGE_BYTES, device="cuda",
                   emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert report["mode"] == "paged" and "prefix_cache" in report, report.get("mode")
    assert launches["posit_attention_paged"] > 0 and launches["posit_attention"] == 0, launches
    assert report["requests"] == 8, report["requests"]
    assert all(n == 16 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the paged serve"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV pool"
    DETAILS["paged_serve_events"] = events
    return report, launches


def eager_twin(engine):
    """The eager twin of an engine class: the class with the decode step that
    its ``_build_executables`` hands ``_bind_decode`` run eagerly, op by op,
    on the card, not captured. The captured graph's twin in
    ``profile_decode`` and the card's tests; the shipped engines have no
    switch to it."""

    def bind(self, decode, state):
        self._decode = decode

    return type(f"Eager{engine.__name__}", (engine,), {"_bind_decode": bind})


EagerTwin = eager_twin(ContinuousBatchingEngine)   # the slot grid's


SWAP_STEP = 2   # the decode step after which a recorded run swaps its policy


def served_recorded(eng, reqs, swap=None) -> tuple[dict, list]:
    """``reqs`` (at most ``eng.max_slots``) admitted together and served to
    the end, every decode step's logits cloned as the sampler saw them; with
    ``swap``, ``eng.apply_policy(swap)`` after step ``SWAP_STEP``, the rows
    live. Returns the token streams and the logits a step."""
    for r in reqs:
        eng.submit(r)
    eng.admit()
    seen, sample = [], eng._next_token
    eng._next_token = lambda logits: (seen.append(logits.clone()), sample(logits))[1]
    try:
        while eng.active.any():
            if swap is not None and eng.steps == SWAP_STEP:
                eng.apply_policy(swap)
            eng.step()
    finally:
        del eng._next_token   # the class's method again (an instance attribute is a cycle)
    torch.cuda.synchronize()
    return {c.rid: c.tokens for c in eng.completions}, seen


def assert_bit_identical(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), f"{what}: {len(got)} logit rows against {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            f"{what}: the logits of decode step {i + 1} differ"


def _step_stats(eng, steps: int, share: bool) -> dict:
    """``steps`` steps timed, then ``steps`` steps under torch.profiler
    (device time by kernel name and the device-busy share of the window),
    the wrappers' launches a step and the GEMM kernels a step by datapath
    and B kind; with ``share``, one more step records the share of the
    quire GEMM's products that took its per-product branch (not timed)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    seen = {}

    def window():
        seen["before"] = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        seen["window_us"] = (time.perf_counter() - t0) * 1e6

    _, dev, _ = whole_window(window, ProfilerActivity.CPU, ProfilerActivity.CUDA)
    before, window_us = seen["before"], seen["window_us"]
    step_launches = {k: (kernels.LAUNCHES[k] - before[k]) / steps for k in before}
    quire_calls = kernels.LAUNCHES["posit_quire_gemm"] - before["posit_quire_gemm"]
    shares = quire_step_share(eng) if share else None
    totals: dict = {}
    for e in dev:
        us, c = totals.get(e.name, (0.0, 0))
        totals[e.name] = (us + e.device_time_total, c + 1)
    by_name = sorted(((n, us, c) for n, (us, c) in totals.items()), key=lambda r: -r[1])
    busy_us = sum(us for _, us, _ in by_name)
    epilogue_calls = sum(c for n, _, c in by_name if "splitk_epilogue" in n)
    # the GEMM's datapaths by kernel name: tensor cores (the decode and
    # 64-row tiles, the mid-M kernel), and the f32-FMA decode (M <= 8) and
    # tile kernels; the packed variants are the templates whose B kind is 4
    variants, variants_us = {}, {}
    for n, us, c in by_name:
        mid = re.search(r"mid_gemm_kernel<(\d+), (\d+)", n)
        m = None if mid else re.search(r"(tc_gemm_kernel|gemv_kernel|gemm_kernel)<(\d+), (\d+)",
                                       n)
        if m or mid:
            key = (f"{m.group(1)} B kind {m.group(3)}" if m
                   else f"mid_gemm_kernel B kind {mid.group(1)}")
            variants[key] = variants.get(key, 0) + c / steps
            variants_us[key] = variants_us.get(key, 0.0) + us / steps
    # the gather / index_put kernels (a KV write outside the attention kernel)
    index_kernels = sum(c for n, _, c in by_name if "index" in n.lower())
    groups = device_groups(totals, steps)
    quire_kernels = sum(c for n, _, c in by_name if "quire" in n)
    quire_readouts = sum(c for n, _, c in by_name if "quire" in n and "readout" in n)
    # the profiler slows the host several-fold, so the idle share is the
    # device time per step against the step time measured without it
    busy_per_step_us = busy_us / steps
    return {"step_ms": step_ms, "decode_tok_per_s": eng.max_slots / step_ms * 1e3,
            "profiled_steps": steps, "profiled_window_us": window_us,
            "device_busy_us_per_step": busy_per_step_us,
            "splitk_epilogue_calls_per_step": epilogue_calls / steps,
            "quire_gemm_calls_per_step": quire_calls / steps,
            "launches_per_step": step_launches,
            "gemm_kernels_per_step": variants,
            "gemm_kernel_us_per_step": variants_us,
            "quire_kernels_per_step": quire_kernels / steps,
            "index_kernels_per_step": index_kernels / steps,
            "launches_all_kernels_per_step": sum(c for _, _, c in by_name) / steps,
            "quire_readout_kernels_per_step": quire_readouts / steps,
            "quire_per_product_share": shares,
            "kernel_counts": {n: c for n, _, c in by_name},
            "device_ms_per_step_by_group": groups,
            "device_idle_share": max(0.0, 1 - busy_per_step_us / (step_ms * 1e3)),
            "top": [{"name": n[:90], "device_us_per_step": us / steps, "calls_per_step":
                     c / steps} for n, us, c in by_name[:14]]}


# the port's kernels by name: the posit GEMM's (its bf16 passes and split-K
# sums included) and attention's; any other GEMM or GEMV kernel is a
# library's (the tied read-out's torch.matmul)
POSIT_GEMM_KERNELS = re.compile(r"(gemm|gemv|mid_a16|large_wgmma|large_fma|a_bf16|b_bf16|"
                                r"splitk_epilogue)_kernel")
LIBRARY_GEMM = re.compile(r"gemm|gemv|xmma|cutlass", re.IGNORECASE)


def device_groups(totals: dict, steps: int) -> dict:
    """Device ms a step by group, from {kernel name: (us, calls)} over
    ``steps`` steps: the posit GEMM, attention, library GEMMs (cuBLAS) and
    the glue (every other kernel)."""
    out = {"posit_gemm": 0.0, "attention": 0.0, "library_gemm": 0.0, "glue": 0.0}
    for name, (us, _) in totals.items():
        short = kernel_name(name)
        key = ("posit_gemm" if POSIT_GEMM_KERNELS.search(short) else
               "attention" if short.startswith("attn_kernel") else
               "library_gemm" if LIBRARY_GEMM.search(short) else "glue")
        out[key] += us / steps / 1e3
    return out


# a profiled request's new tokens: room for the profiled window's retries
PROFILE_GEN = 32


def profile_decode(arch=QWEN, policy=P8_SERVE, prompt_len: int = 64, steps: int = 4,
                   share: bool = False, swap=None, engine=ContinuousBatchingEngine,
                   engine_kw=None, slots: int = 4, model=None, params=None,
                   keep_recorded: bool = False, twin: bool = True,
                   gen: int = PROFILE_GEN) -> dict:
    """Where a decode step's time goes, with the step captured in a CUDA
    graph and run eagerly (``EagerTwin``): the full model at 4 busy slots,
    the same params, requests and seeds for both. Each engine first serves
    4 requests to the end recording every decode step's logits
    (``served_recorded``; with ``swap``, a mid-flight ``apply_policy`` after
    step ``SWAP_STEP`` and back to ``policy`` after the run), is reset, then
    admits them again, takes a step, is timed and profiled (``_step_stats``;
    with ``share`` the twin's extra step counts the quire's per-product
    branch, and the graph engine takes a plain step there) and runs them
    out. The two must agree: the same tokens in both runs, every recorded
    logit bit for bit, the same launch counts a step and over the timed run,
    and within one kernel a step of the same profiled kernels. Returns the
    graph's numbers, the twin's under "eager" and the comparison under
    "graph_vs_eager". ``engine`` is the engine class (its eager twin from
    ``eager_twin``), built with ``engine_kw`` too, at ``slots`` slots and
    as many requests of ``prompt_len`` + ``gen`` tokens
    (``profile_requests``). ``model`` and ``params`` are
    the caller's if given (else built from ``arch``, seed 0); with
    ``keep_recorded`` the graph run's recorded streams and logits are under
    "recorded". Without ``twin`` only the graph half runs: its numbers, with
    no eager run and no comparison."""
    own = model is None
    if own:
        model = build_model(arch)
        params = model.init(0, policy)
    runs = {}
    halves = (("graph", engine), ("eager", eager_twin(engine)))
    for name, cls in halves if twin else halves[:1]:
        kernels.reset_launches()
        eng = cls(model, params, policy, max_slots=slots, S_max=prompt_len + gen,
                  **(engine_kw or {}))
        reqs = profile_requests(arch, slots, prompt_len, gen)
        recorded = served_recorded(eng, reqs, swap)
        if swap is not None:
            eng.apply_policy(policy)
        eng.reset()
        kernels.reset_launches()
        for r in reqs:
            eng.submit(r)
        eng.admit()
        eng.step()
        stats = _step_stats(eng, steps, share and name == "eager")
        if share and name == "graph":
            eng.step()
        while eng.active.any():
            eng.step()
        torch.cuda.synchronize()
        # (kernel_timings.py runs this on older packages, whose engine has no _decode)
        stats["captured"] = type(getattr(eng, "_decode", None)).__name__ == "CapturedStep"
        stats["run_launches"] = dict(kernels.LAUNCHES)
        runs[name] = (stats, recorded, {c.rid: c.tokens for c in eng.completions})
        del eng
        torch.cuda.empty_cache()
    graph, (g_rec, g_seen), g_tokens = runs["graph"]
    if swap is None:
        assert g_tokens == g_rec, f"{arch.name}: the run after a reset served other tokens"
    if not twin:
        if own:
            del params, model
        torch.cuda.empty_cache()
        return graph
    eager, (e_rec, e_seen), e_tokens = runs["eager"]
    assert g_tokens == e_tokens and g_rec == e_rec, \
        f"{arch.name}: graph and eager token streams differ"
    assert_bit_identical(g_seen, e_seen, f"{arch.name}: graph against eager")
    assert graph["run_launches"] == eager["run_launches"], (graph["run_launches"],
                                                           eager["run_launches"])
    assert graph["launches_per_step"] == eager["launches_per_step"]
    # the profiler reports the kernels inside a graph launch by name
    gc, ec = graph["kernel_counts"], eager["kernel_counts"]
    assert abs(graph["launches_all_kernels_per_step"]
               - eager["launches_all_kernels_per_step"]) <= 1, \
        (f"{arch.name}: the profiler saw {graph['launches_all_kernels_per_step']} kernels a "
         f"graph step, {eager['launches_all_kernels_per_step']} an eager one; rows that "
         "differ (graph, eager calls in the window): "
         + str({n[:80]: (gc.get(n, 0), ec.get(n, 0)) for n in set(gc) | set(ec)
                if gc.get(n, 0) != ec.get(n, 0)}))
    out = dict(graph, quire_per_product_share=eager["quire_per_product_share"], eager=eager)
    out["graph_vs_eager"] = {
        "decode_steps_compared": len(g_seen),
        "tokens_compared": sum(map(len, g_tokens.values())) + sum(map(len, g_rec.values())),
        "swap": None if swap is None else {
            "after_step": SWAP_STEP,
            "changed": {k: v for k, v in swap.to_json().items() if v != policy.to_json()[k]}},
        "bit_identical": True, "launches_equal": True,
        "wall_speedup": eager["step_ms"] / graph["step_ms"]}
    if keep_recorded:
        out["recorded"] = (g_rec, g_seen)
    if own:
        del params, model
    torch.cuda.empty_cache()
    return out


def profile_requests(arch, slots: int, prompt_len: int, gen: int = PROFILE_GEN) -> list:
    """The requests of a ``profile_decode`` run: ``slots`` prompts at t = 0."""
    return poisson_requests(slots, arrival_rate=0.0, prompt_lens=(prompt_len,),
                            max_new_tokens=gen, vocab=arch.vocab, seed=1)


def graph_line(path: str, prof: dict) -> dict:
    """The graph-against-eager figures of a profiled path, for its log line."""
    keys = ("step_ms", "device_busy_us_per_step", "device_idle_share", "decode_tok_per_s",
            "launches_all_kernels_per_step")
    return {"path": path, "captured": prof["captured"],
            "graph": {k: prof[k] for k in keys}, "eager": {k: prof["eager"][k] for k in keys},
            **prof["graph_vs_eager"]}


def profile_log(prof: dict) -> dict:
    """A profile's log line: everything but the kernel tables and the twin."""
    return {k: v for k, v in prof.items()
            if k not in ("top", "eager", "kernel_counts")}


def assert_kv_write_fused(prof: dict, arch, name: str, encodes: float = 0,
                          attention: str = "posit_attention", rope_bases: int = 1) -> None:
    """A decode step writes its K/V rows inside the attention kernel: one
    ``attention`` launch a layer (the dense kernel, or the paged one), none
    of the other, no encode launch beyond ``encodes`` and no gather or
    index_put kernel of a KV write (the only kernels named "index" are the
    ``torch.arange`` of each of the ``rope_bases`` RoPE tables)."""
    per_step = prof["launches_per_step"]
    other = "posit_attention_paged" if attention == "posit_attention" else "posit_attention"
    assert per_step[attention] == arch.n_layers and per_step[other] == 0, \
        f"{name} decode step: {per_step[attention]} {attention}, {per_step[other]} {other}"
    assert per_step["posit_encode"] == encodes, \
        f"{name} decode step: {per_step['posit_encode']} encode launches, {encodes} expected"
    # rope_freqs' arange runs as elementwise_kernel_with_index, one a RoPE
    # base; a KV write outside the kernel adds two index kernels a layer
    assert prof["index_kernels_per_step"] <= rope_bases, \
        f"{name} decode step: {prof['index_kernels_per_step']} index kernels " + \
        str({n[:120]: c for n, c in prof["kernel_counts"].items() if "index" in n.lower()})


def quire_step_share(eng) -> dict:
    """One engine step with every quire GEMM call's operands run through the
    window rule (ref.py ``per_product_share``): the share of the step's
    products that took the per-product branch."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.kernels.posit_quire_gemm.ref import per_product_share
    seen = {"calls": 0, "products": 0, "per_product": 0}
    kernel = quire_ops.posit_quire_gemm

    def counted(a, b, es, **kw):
        count, _ = per_product_share(a, b, es, a_fmt=kw["a_fmt"], b_fmt=kw["b_fmt"])
        seen["calls"] += 1
        seen["products"] += a.shape[0] * a.shape[1] * b.shape[1]
        seen["per_product"] += count
        return kernel(a, b, es, **kw)

    quire_ops.posit_quire_gemm = counted
    try:
        eng.step()
        torch.cuda.synchronize()
    finally:
        quire_ops.posit_quire_gemm = kernel
    return dict(seen, share=seen["per_product"] / max(1, seen["products"]))


# ------------------------------------------------------------ training ----
# (the training modules are imported inside these functions: kernel_timings.py
# imports this file with older packages, which have none)

# the full-width train path: phi3-mini-3.8b, 16 of its 32 layers, 8 x 512 tokens a step
TRAIN_CFG = dataclasses.replace(PHI3, n_layers=16)
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
TRAIN_ARGV = ("--arch", PHI3.name, "--layers", str(TRAIN_CFG.n_layers), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1", "--seed", "0")
# phi3's linear shapes (K, N) with the activation fused in: q/k/v/o, gate
# (silu; up the same shape without), down and lm_head (one loss chunk: S 512
# is below LOSS_CHUNK, so the head runs at all M rows)
PHI3_TRAIN_LINEARS = ((3072, 3072, "none"), (3072, 8192, "silu"), (8192, 3072, "none"),
                      (3072, 32064, "none"))     # ... and lm_head
ULP = 2.0 ** -23                        # f32 spacing at 1


def _leaf_items(tree, path=""):
    """(path, leaf) of a port tree in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{path}/{i}")
    else:
        yield path, tree


def check_train_reduced(steps: int = 3, device=DEV) -> dict:
    """(a) Reduced qwen2.5-14b and phi3-mini-3.8b under ``none`` and
    ``p16-train``: three train steps on the card against the same on the
    CPU. Each step starts both from the card's state and batch (copied to
    the CPU), so the checks hold one step each and do not compound:
    - the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
      largest magnitude (f32 products and sums in another order, the GEMM
      kernel's among them);
    - the update, both sides from the card's gradients: AdamW divides the
      first moment by the root of the second, so a gradient element at the
      level of summation noise (a sum that cancels) would turn the two
      sides' noise into steps of up to lr apart; on the same gradients the
      update is elementwise f32 arithmetic, and every parameter and f32
      moment leaf is held within 8 f32 ulps of the leaf's largest magnitude
      (``b ** count``, the clip norm's sum order), p16 moment codes within 1
      code, and the moment each stores (decoded code plus error-feedback
      residual) within 8 ulps of the leaf's largest magnitude."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    res, worst = [], {"loss_rel": 0.0, "grad_rel": 0.0, "param_ulps": 0.0, "moment_ulps": 0.0,
                      "code_diff": 0}

    def cpu(tree):
        return tree_map(lambda t: t.detach().cpu().clone(), tree)

    for arch in (QWEN, PHI3):
        cfg = arch.reduced()
        for spec in ("none", "p16-train"):
            pol = parse_policy(spec)
            opt_cfg = AdamWConfig(moment_fmt=pol.optimizer)
            models = {d: build_model(cfg, device=d) for d in (device, "cpu")}
            tsteps = {d: make_train_step(models[d], pol, opt_cfg, warmup=1, total_steps=steps)
                      for d in models}
            params = models[device].init(0)
            opt = adamw_init(params, opt_cfg)
            pipe = SyntheticLMPipeline(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0,
                                       device=device)
            losses = []
            for i in range(steps):
                b = pipe.batch_at(i)
                p_c, o_c, b_c = cpu(params), cpu(opt), cpu(b)
                lg, mg, gg = tsteps[device].loss_and_grads(params, b)
                lc, mc, gc = tsteps["cpu"].loss_and_grads(p_c, b_c)
                rel = abs(float(lg) - float(lc)) / abs(float(lc))
                assert torch.isfinite(lg) and rel <= 1e-5, (cfg.name, spec, i, rel)
                worst["loss_rel"] = max(worst["loss_rel"], rel)
                for (path, g), c in zip(_leaf_items(gg), tree_leaves(gc)):
                    err = float((g.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                    assert err <= 1e-4, (cfg.name, spec, i, path, err)
                    worst["grad_rel"] = max(worst["grad_rel"], err)
                params, opt, _ = tsteps[device].apply_update(params, opt, gg, i, lg, mg)
                p_c, o_c, _ = tsteps["cpu"].apply_update(p_c, o_c, cpu(gg), i, lc, mc)
                for (path, p), c in zip(_leaf_items(params), tree_leaves(p_c)):
                    c = c.detach()
                    ulps = float((p.detach().cpu() - c).abs().max()) / (
                        ULP * max(float(c.abs().max()), 1e-30))
                    assert ulps <= 8, (cfg.name, spec, i, path, ulps)
                    worst["param_ulps"] = max(worst["param_ulps"], ulps)
                _check_moments(params, opt["mu"], o_c["mu"], pol.optimizer, worst,
                               (cfg.name, spec, i))
                losses.append(float(lg))
            res.append({"arch": cfg.name, "policy": spec, "losses": losses})
    return {"runs": res, "worst": worst}


def _check_moments(params, mu_dev, mu_cpu, fmt, worst: dict, where) -> None:
    """The card's AdamW moments against the CPU's after one update from the
    same state and gradients (``check_train_reduced``'s bounds)."""
    from repro_torch.core.tree import tree_map

    def leaf(_, st, st_c):
        assert set(st) == set(st_c), where
        for m in ("m", "v"):
            g, c = st[m].cpu(), st_c[m]
            if fmt is None:
                val_g, val_c = g, c
            else:
                d = int((g.to(torch.int32) - c.to(torch.int32)).abs().max())
                assert d <= 1, (where, m, d)
                worst["code_diff"] = max(worst["code_diff"], d)
                if "e" + m not in st:
                    continue
                val_g = codec_ref.decode_ref(g, fmt.es, nbits=fmt.nbits) + st["e" + m].cpu()
                val_c = codec_ref.decode_ref(c, fmt.es, nbits=fmt.nbits) + st_c["e" + m]
            ulps = float((val_g - val_c).abs().max()) / (ULP * max(float(val_c.abs().max()),
                                                                    1e-30))
            assert ulps <= 8, (where, m, ulps)
            worst["moment_ulps"] = max(worst["moment_ulps"], ulps)

    tree_map(leaf, params, mu_dev, mu_cpu)


def check_linear_backward(M: int = TRAIN_M, device=DEV) -> dict:
    """(b) ``FloatLinear``'s backward (the float-weight linear of the
    training path) at M rows and phi3's q/o, gate/up (silu fused), down
    and lm_head shapes, under f32 and bf16 compute, against a float64
    autograd of the same function on the operands as the kernel sees them
    (x and w rounded to the compute dtype). With u = 2^-24, z the pre-activation, |.|
    elementwise and @ the product of absolute values:
    - z, in the kernel's forward and recomputed: e_z = 2*K*u*(|x|@|w|) +
      2*u*|b|; the forward's y = act(z) + residual within e_z (1.1*e_z
      under silu, |silu'| <= 1.1) + 2*u*|y|;
    - dz = dy * act'(z): e_dz = 0.5*|dy|*e_z (silu'' <= 0.5) + 4*u*|dz|,
      0 without an activation;
    - dx: 2*N*u*(|dz|@|w^T|) + e_dz@|w^T|;
    - dw: e_dw = 2*M*u*(|x^T|@|dz|) + |x^T|@e_dz, plus 2^-8*(|dw| + e_dw)
      when dw is rounded to bf16 (w's dtype under bf16 compute);
    - db: 2*M*u*sum|dz| + sum e_dz; dresidual: dy exactly."""
    from repro_torch.core.dot import _apply_activation
    from repro_torch.kernels.posit_gemm.ops import float_linear

    u = 2.0 ** -24
    cases = []
    for K, N, act in PHI3_TRAIN_LINEARS:
        g = gen(40) if device == DEV else torch.Generator().manual_seed(40)
        x = torch.randn((M, K), generator=g, device=device)
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        b = torch.randn((N,), generator=g, device=device) * 0.1
        r = torch.randn((M, N), generator=g, device=device)
        dy = torch.randn((M, N), generator=g, device=device)
        for cd in (torch.float32, torch.bfloat16):
            xs = x.clone().requires_grad_(True)
            ws = w.to(cd).clone().requires_grad_(True)
            bs, rs = b.clone().requires_grad_(True), r.clone().requires_grad_(True)
            y = float_linear(xs, ws, compute_dtype=cd, bias=bs, residual=rs, activation=act)
            y.backward(dy)
            x64 = x.to(cd).double().requires_grad_(True)
            w64 = w.to(cd).double().requires_grad_(True)
            b64 = b.double().requires_grad_(True)
            z64 = x64 @ w64 + b64
            (_apply_activation(z64, act) + r.double()).backward(dy.double())
            zz = z64.detach().requires_grad_(True)
            dz64 = dy.double() if act == "none" else torch.autograd.grad(
                _apply_activation(zz, act), zz, dy.double())[0]
            with torch.no_grad():
                ax, aw = x64.detach().abs(), w64.detach().abs()
                e_z = 2 * K * u * (ax @ aw) + 2 * u * b64.detach().abs()
                e_dz = (torch.zeros_like(e_z) if act == "none"
                        else 0.5 * dy.double().abs() * e_z + 4 * u * dz64.abs())
                adz = dz64.abs()
                lim_dx = 2 * N * u * (adz @ aw.T) + e_dz @ aw.T
                lim_dw = 2 * M * u * (ax.T @ adz) + ax.T @ e_dz
                if cd == torch.bfloat16:
                    lim_dw = lim_dw + 2.0 ** -8 * (w64.grad.abs() + lim_dw)
                lim_db = 2 * M * u * adz.sum(0) + e_dz.sum(0)
                y64 = _apply_activation(z64.detach(), act) + r.double()
                lim_y = (1.1 if act == "silu" else 1.0) * e_z + 2 * u * y64.abs()
                ratios = {}
                for name, got, want, lim in (("y", y.detach(), y64, lim_y),
                                             ("dx", xs.grad, x64.grad, lim_dx),
                                             ("dw", ws.grad, w64.grad, lim_dw),
                                             ("db", bs.grad, b64.grad, lim_db)):
                    err = (got.double() - want).abs()
                    ratios[name] = float((err / lim.clamp_min(1e-300)).max())
                    assert ratios[name] <= 1.0, (K, N, act, str(cd), name, ratios[name])
                assert torch.equal(rs.grad, dy), "dresidual is not dy"
            cases.append({"K": K, "N": N, "activation": act,
                          "compute": str(cd).split(".")[-1],
                          "err_over_limit": ratios})
            del xs, ws, y, x64, w64, z64, zz, dz64, y64
        del x, w, r, dy
        if device == DEV:
            torch.cuda.empty_cache()
    return {"M": M, "cases": cases,
            "worst_err_over_limit": max(max(c["err_over_limit"].values()) for c in cases)}


class LineClock:
    """A stdout stand-in that keeps each complete line with the host time at
    which its newline arrived (``train.main`` flushes a ``train/step`` line
    after reading the step's metrics, which waits for the card)."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s: str) -> int:
        now = time.perf_counter()
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((now, line))
        return len(s)

    def flush(self) -> None:
        pass


class CodecCheck:
    """Holds the codec launches of one train step against the plain codec on
    the same inputs, bit for bit: every encode whose input is one of
    ``ste_weights`` (the straight-through estimator's encode of a layer's
    weights, in the forward and again under remat) and every decode of the
    codes those wrote; every encode of an f32 tensor of ``moment_shape``
    that is not ``skip`` (the AdamW moments of that leaf) and every decode
    of ``moment_codes`` (the leaf's codes before the step) or of codes those
    encodes wrote. It wraps ``codec_ops.encode`` and ``decode``, which the
    layers and the optimizer call through the module."""

    CHUNK = 1 << 24     # elements a plain-version call (bounds its int64 temporaries)

    def __init__(self, ste_weights, moment_shape, skip, moment_codes):
        self.ste = {w.data_ptr() for w in ste_weights}
        self.moment_shape, self.skip = tuple(moment_shape), skip.data_ptr()
        self.decode_watch = {c.data_ptr(): "moment" for c in moment_codes}
        self.checked = {"ste_encode": 0, "ste_decode": 0, "moment_encode": 0,
                        "moment_decode": 0}

    def _same(self, kind, got, x, es, nbits):
        ref = codec_ref.encode_ref if kind == "encode" else codec_ref.decode_ref
        g, xin = got.reshape(-1), x.reshape(-1)
        for i in range(0, xin.numel(), self.CHUNK):
            want = ref(xin[i:i + self.CHUNK], es, nbits=nbits)
            part = g[i:i + self.CHUNK]
            if kind == "encode":
                ok = torch.equal(part.view(torch.int16 if nbits == 16 else torch.int8),
                                 want.view(torch.int16 if nbits == 16 else torch.int8))
            else:
                ok = torch.equal(part.view(torch.int32), want.view(torch.int32))
            assert ok, f"the {kind} kernel's output differs from the plain version's"

    def __enter__(self):
        self._enc, self._dec = codec_ops.encode, codec_ops.decode

        def encode(x, es, *, nbits, **kw):
            out = self._enc(x, es, nbits=nbits, **kw)
            ptr = x.data_ptr()
            what = ("ste" if ptr in self.ste else
                    "moment" if (tuple(x.shape) == self.moment_shape and ptr != self.skip
                                 and x.dtype == torch.float32) else None)
            if what:
                self._same("encode", out, x, es, nbits)
                self.checked[what + "_encode"] += 1
                self.decode_watch[out.data_ptr()] = what
            return out

        def decode(codes, es, *, nbits, **kw):
            out = self._dec(codes, es, nbits=nbits, **kw)
            what = self.decode_watch.get(codes.data_ptr())
            if what and kw.get("out_dtype", torch.float32) == torch.float32:
                self._same("decode", out, codes, es, nbits)
                self.checked[what + "_decode"] += 1
            return out

        codec_ops.encode, codec_ops.decode = encode, decode
        return self

    def __exit__(self, *exc):
        codec_ops.encode, codec_ops.decode = self._enc, self._dec


def cpu_tensor_ops(fn) -> list:
    """Run ``fn()`` and return the aten ops on its path that touched a CPU
    tensor holding data: any op that made one with an element, or read one
    with a dimension (a 0-dim CPU tensor is how a Python scalar reaches an
    op; ``torch.utils.checkpoint`` makes an empty one as its autograd
    anchor), and every host sync (``_local_scalar_dense``); each with the
    innermost frames of this repository's code that called it."""
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as pt_leaves

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in pt_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in pt_leaves(out) if isinstance(t, torch.Tensor)]
            if (func is torch.ops.aten._local_scalar_dense.default
                    or any(t.device.type == "cpu" and t.numel() > 0 for t in outs)
                    or any(t.device.type == "cpu" and t.dim() > 0 for t in ins)):
                frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()
                          if ("repro_torch" in f.filename or "chip_smoke" in f.filename)
                          and f.name != "__torch_dispatch__"]
                seen.append(f"{func} at {' < '.join(reversed(frames[-4:]))}")
            return out

    with Watch():
        fn()
    return seen


TRAIN_KERNELS = {
    "posit_gemm_large_fma": r"\blarge_fma_kernel\b",
    "posit_gemm_large_tc": r"\b(large_wgmma_kernel|a_bf16_kernel|b_bf16_kernel)\b",
    "posit_gemm": r"\b(tc_gemm_kernel|gemv_kernel|gemm_kernel|splitk_epilogue_kernel)\b",
    "posit_encode": r"\bencode_kernel\b", "posit_decode": r"\bdecode_kernel\b"}


def profile_train_step(step_fn, params, opt, batch, step: int) -> dict:
    """One train step under torch.profiler (another while the profiler
    loses the window, ``whole_window``): device ms, each port kernel's
    calls and device ms, the backward products' (``FloatLinear.backward``'s
    ``posit_gemm_backward`` range: torch.matmul and the activation's
    derivative), the wrappers' launches, and the top rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    seen = {}

    def window():
        seen["before"] = dict(kernels.LAUNCHES)
        step_fn(params, opt, batch, step)
        torch.cuda.synchronize()

    # the device's own records (kernels, copies, sets), one each: not the key
    # averages, where a CPU range (the autograd Function's, the backward's
    # annotation) would carry its kernels' time a second time
    prof, dev, _ = whole_window(window, ProfilerActivity.CPU, ProfilerActivity.CUDA)
    before = seen["before"]
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before
                if kernels.LAUNCHES[k] != before[k]}
    events = prof.events()
    out = {"device_ms": sum(e.device_time_total for e in dev) / 1e3, "kernels_per_step": len(dev),
           "launches": launches, "kernels": {}}
    for name, pat in TRAIN_KERNELS.items():
        hit = [e for e in dev if re.search(pat, e.name)]
        out["kernels"][name] = {"calls": len(hit),
                                "device_ms": sum(e.device_time_total for e in hit) / 1e3}
    bwd = [e for e in events if e.name == "posit_gemm_backward" and e.device_type == DeviceType.CPU]
    out["kernels"]["backward_matmul"] = {
        "calls": len(bwd), "device_ms": sum(e.device_time_total for e in bwd) / 1e3}
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total / 1e3, c + 1)
    out["top"] = [{"name": n[:90], "device_ms": t, "calls": c}
                  for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]]
    return out


def run_train_path(policy: str, steps: int, checks: bool, *, argv=TRAIN_ARGV, cfg=TRAIN_CFG,
                   batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """(c) ``repro_torch.launch.train.main`` at phi3-mini-3.8b's full width
    and 16 of its 32 layers, batch 8 x seq 512, ``steps`` steps, the launch
    counts set to 0 just before and read just after (the launches a step:
    the run's less AdamW's init); the step wall times from the flushed
    ``train/step`` lines. Then, on the state it returns and
    the next batches: with ``checks``, one step under ``CodecCheck`` (layer
    0's seven weights, lm_head's moments), one under ``cpu_tensor_ops``, and
    the loss's fall over the run; then one step under the profiler. Returns
    the ``train_path`` line."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    argv = list(argv) + ["--policy", policy, "--steps", str(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = LineClock()
    kernels.reset_launches()
    t0 = time.perf_counter()
    real_stdout, sys.stdout = sys.stdout, clock
    try:
        state = train.main(argv)
    finally:
        sys.stdout = real_stdout
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    recs = [(t, json.loads(line)) for t, line in clock.lines]
    step_recs = [(t, r) for t, r in recs if r["kind"] == "train/step"]
    assert [r["step"] for _, r in step_recs] == list(range(steps)), recs
    assert recs[-1][1]["kind"] == "train/done", recs[-1]
    losses = [r["loss"] for _, r in step_recs]
    assert all(np.isfinite(losses)), losses
    walls = [b[0] - a[0] for a, b in zip(step_recs, step_recs[1:])]
    wall = statistics.median(walls)
    pol = parse_policy(policy)
    # every linear at M = 4,096 on the 128 x 128 f32-FMA tile (on posit_gemm in
    # a package from before it, which kernel_timings.py runs too)
    gemm_key = "posit_gemm_large_fma" if "posit_gemm_large_fma" in launches else "posit_gemm"
    for name in (gemm_key,) + (("posit_encode", "posit_decode") if pol.weights else ()):
        assert launches[name] > 0, f"kernel {name} was not launched on the train path"
    if pol.weights is None:
        assert launches["posit_encode"] == launches["posit_decode"] == 0, launches

    model = build_model(cfg, device=DEV)
    opt_cfg = AdamWConfig(moment_fmt=pol.optimizer)
    step_fn = make_train_step(model, pol, opt_cfg, warmup=max(steps // 10, 1), total_steps=steps)
    pipe = SyntheticLMPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
                               device=DEV)
    params, opt = state["params"], state["opt"]
    line = {"policy": policy, "arch": cfg.name, "layers": cfg.n_layers,
            "tokens_per_step": batch * seq, "steps": steps, "losses": losses,
            "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall * 1e3,
            "first_step_s": step_recs[0][0] - t0, "tokens_per_s": batch * seq / wall,
            "peak_memory_gb": peak / 1e9,
            # the run's counts, AdamW's zero moments encoded at init included
            "launches_run": {k: v for k, v in launches.items() if v}}
    DETAILS[f"train_path_{policy}"] = line      # kept if a check below fails
    if checks:
        lm = params["lm_head"]["w"]
        mu = opt["mu"]["lm_head"]["w"]
        layer0 = [p["w"] for p in (*params["blocks"][0]["attn"].values(),
                                   *params["blocks"][0]["mlp"].values())]
        with CodecCheck(layer0, lm.shape, lm, (mu["m"], mu["v"])) as cc:
            step_fn(params, opt, pipe.batch_at(steps), steps)
            torch.cuda.synchronize()
        assert cc.checked["ste_encode"] >= 14 and cc.checked["ste_decode"] >= 14, cc.checked
        assert cc.checked["moment_encode"] >= 2 and cc.checked["moment_decode"] >= 4, cc.checked
        batch = pipe.batch_at(steps + 1)
        cpu_ops = cpu_tensor_ops(lambda: step_fn(params, opt, batch, steps + 1))
        assert not cpu_ops, f"CPU tensors on the train step's path: {cpu_ops[:6]}"
        assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
        line["codec_bit_exact_calls"] = cc.checked
        line["cpu_tensor_ops"] = 0
    # the run's launches a step: its counts less AdamW's init, which encodes
    # both zero moments of every leaf under posit moments
    init = {"posit_encode": 2 * len(tree_leaves(params)) if pol.optimizer else 0}
    per_step = {k: (v - init.get(k, 0)) / steps for k, v in launches.items()
                if v - init.get(k, 0)}
    # device time from one more step of the same step function under the
    # profiler (its wall time is the profiler's, so the idle share sets it
    # against the run's median step wall); that step's launches must be the
    # run's a step
    prof = profile_train_step(step_fn, params, opt, pipe.batch_at(steps + 2), steps + 2)
    assert prof["launches"] == per_step, (prof["launches"], per_step)
    line.update(device_ms=prof["device_ms"], idle_share=1 - prof["device_ms"] / (wall * 1e3),
                launches_per_step=per_step, kernel_per_step=prof["kernels"])
    DETAILS[f"train_profile_{policy}"] = prof
    return line


def event_ms(fn, *, windows: int = 3, calls: int = 5) -> float:
    """Time of one call of ``fn`` from CUDA events around ``calls``
    back-to-back calls, median over ``windows``, after a warm-up call. For
    calls of 0.1 ms and more, where the host enqueues faster than the card
    runs: there torch.profiler has lost kernel records of cuBLAS calls (a
    window of three 4 ms calls read 2.7 ms a call, one of a bf16 call
    below its bound), and events see every kernel."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def train_timings(M: int = TRAIN_M, layers: int = 16) -> dict:
    """The training path's kernels at its shapes. The GEMM with float B as
    ``FloatLinear`` calls it (f32 activations, f32 out) at M rows and phi3's
    linear shapes (lm_head included), under f32 compute (f32 B, the f32-FMA
    tile kernel) and bf16 compute (bf16 B, the tensor cores), each beside its
    bound, its plain version, the kernels below LARGE_M forced at the same
    shape (``tile64_ms``) and one torch.matmul on the same dtypes (f32
    with TF32 off; bf16 x bf16). The codec at phi3's largest weight (32064 x
    3072): encode f32 -> p16_1 and decode p16_1 -> f32 beside the bound
    and the plain version. Times from CUDA events (``event_ms``).
    ``per_train_step``: the launches of that shape a p16-train step of
    ``layers`` layers makes (every forward linear twice, remat; the codec at
    lm_head's size: its straight-through encode and decode twice, and the
    moments of lm_head and the embedding)."""
    from repro_torch.core.dot import float_fmt

    per_step = {(3072, 3072): 8 * layers, (3072, 8192): 4 * layers, (8192, 3072): 2 * layers,
                (3072, 32064): 2}
    gemm = []
    for K, N in per_step:
        a = torch.randn((M, K), generator=gen(50), device=DEV)
        w = torch.randn((K, N), generator=gen(51), device=DEV) * K ** -0.5
        for cd in (torch.float32, torch.bfloat16):
            b = w.to(cd)
            kw = dict(a_fmt=F32, b_fmt=float_fmt(cd), out_fmt=F32, compute_dtype=cd)
            ms = event_ms(lambda: posit_gemm(a, b, (0, 0, 0), **kw))
            with forced_route(False):   # the 64-row tiles, in a package that has both
                tile64 = event_ms(lambda: posit_gemm(a, b, (0, 0, 0), **kw))
            ac = a.to(cd)
            lib = event_ms(lambda: torch.matmul(ac, b))
            plain = event_ms(lambda: posit_gemm_ref(a, b, (0, 0, 0), **kw), calls=2)
            nbytes = a.numel() * 4 + b.numel() * b.element_size() + M * N * 4
            kind = "f32" if cd == torch.float32 else "bf16"
            b_ms, by = bound_ms(nbytes, 2.0 * M * K * N, kind)
            gemm.append({"M": M, "K": K, "N": N, "compute": kind, "ms": ms, "tile64_ms": tile64,
                         "plain_ms": plain,
                         "library_ms": lib, "bound_ms": b_ms, "bound_by": by,
                         "kernel_over_library": ms / lib, "per_train_step": per_step[(K, N)]})
            del b, ac
        del a, w
        torch.cuda.empty_cache()
    x = torch.randn((32064, 3072), generator=gen(52), device=DEV) * 0.02
    codes = codec_ops.encode(x, 1, nbits=16)
    n = x.numel()
    codec = {"shape": [32064, 3072], "fmt": "p16_1"}
    for name, fn, ref_fn, per in (
            ("encode", lambda: codec_ops.encode(x, 1, nbits=16),
             lambda: codec_ref.encode_ref(x, 1, nbits=16), 6),
            ("decode", lambda: codec_ops.decode(codes, 1, nbits=16),
             lambda: codec_ref.decode_ref(codes, 1, nbits=16), 10)):
        b_ms, by = bound_ms(n * 6, 0.0)
        codec[name] = {"ms": event_ms(fn, calls=20), "plain_ms": event_ms(ref_fn, calls=2),
                       "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                       "per_train_step": per}
    del x, codes
    torch.cuda.empty_cache()
    return {"gemm": gemm, "codec": codec}


# --------------------------------------------------------------- phase 6 ----

def gemm_timings(M: int, shapes, plain: bool = False) -> list:
    """The fused GEMM as the model calls it (f32 activations rounded to bf16
    in the kernel, p8_0 weights, f32 out) at M rows: device ms, the bound,
    and one bf16 torch.matmul on the weight decoded once (by the kernel,
    outside the timing) as the yardstick; the plain version's ms if asked."""
    rows = []
    for K, N in shapes:
        a, b, _, _ = make_gemm_inputs(M, K, N, P8_0, torch.float32, False, False, seed=4)
        kw = dict(es=(0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32, activation="none",
                  compute_dtype=torch.bfloat16)
        ms = time_ms(lambda: posit_gemm(a, b, (0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32,
                                        compute_dtype=torch.bfloat16))
        wdec = codec_ops.decode(b, 0, nbits=8, out_dtype=torch.bfloat16)
        a16 = a.to(torch.bfloat16)
        lib = time_ms(lambda: torch.matmul(a16, wdec))
        nbytes = a.numel() * 4 + b.numel() + M * N * 4
        rows.append({"M": M, "K": K, "N": N, "ms": ms, "library_ms": lib, "bytes": nbytes,
                     "bound_ms": bound_ms(nbytes, 2 * M * K * N)[0]})
        if plain:
            rows[-1]["plain_ms"] = time_ms(lambda: gemm_plain(a, b, None, None, kw),
                                           windows=3, calls=1)
        del a, b, wdec, a16
        torch.cuda.empty_cache()
    return rows


def packed_timings(M: int, shapes, cd=torch.bfloat16, plain: bool = False) -> list:
    """The packed variant of ``cd`` (tensor cores for bf16, f32 FMA for f32)
    as the layers call it (f32 activations, packed p8_0 lanes, f32 out) at M
    rows: device ms beside the unpacked kernel on the same codes, the bound
    (the unpacked kernel's: a packed code is one byte too), and one
    torch.matmul in ``cd`` on the weight decoded once (by the kernel, outside
    the timing); the plain version's ms if asked."""
    # imported here: kernel_timings.py imports this module with older packages
    from repro_torch.core.pack import pack_p8

    rows = []
    for K, N in shapes:
        a, b, _, _ = make_gemm_inputs(M, K, N, P8_0, torch.float32, False, False, seed=4)
        bp = pack_p8(b)
        kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, compute_dtype=cd)
        ms = time_ms(lambda: posit_gemm(a, bp, (0, 0, 0), b_packed=True, **kw))
        unpacked = time_ms(lambda: posit_gemm(a, b, (0, 0, 0), **kw))
        wdec = codec_ops.decode(b, 0, nbits=8, out_dtype=cd)
        ac = a.to(cd)
        lib = time_ms(lambda: torch.matmul(ac, wdec))
        nbytes = a.numel() * 4 + b.numel() + M * N * 4
        rows.append({"M": M, "K": K, "N": N, "compute": str(cd).split(".")[-1], "ms": ms,
                     "unpacked_ms": unpacked, "library_ms": lib, "bytes": nbytes,
                     "bound_ms": bound_ms(nbytes, 2 * M * K * N,
                                          "bf16" if cd == torch.bfloat16 else "f32")[0]})
        if plain:
            rows[-1]["plain_ms"] = time_ms(
                lambda: posit_gemm_ref(a, bp, (0, 0, 0), b_packed=True, **kw),
                windows=3, calls=1)
        del a, b, bp, wdec, ac
        torch.cuda.empty_cache()
    return rows



def p16_timings(M: int = 4, shapes=P16_KN, plain: bool = False) -> list:
    """The unpacked kernel on p16_1 weights: bf16 compute as the mixed path
    calls it (A and the decoded weight rounded to bf16, f32 sums; the
    tensor-core route, the f32-FMA kernels before it), and f32 compute (the
    f32-FMA kernels); beside the bound of each, one torch.matmul on the
    weight decoded once: bf16 on the bf16-rounded weight (the bf16 route's
    function) and f32 with TF32 off, and the same kernel on that bf16 weight
    (the same bytes, no decode: what the p16 decode adds)."""
    rows = []
    for K, N in shapes:
        a, b, _, _ = make_gemm_inputs(M, K, N, P16_1, torch.float32, False, False, seed=6)
        kw = dict(a_fmt=F32, b_fmt=P16_1, out_fmt=F32)
        ms = time_ms(lambda: posit_gemm(a, b, (0, 1, 0), compute_dtype=torch.bfloat16, **kw))
        ms_f32 = time_ms(lambda: posit_gemm(a, b, (0, 1, 0), compute_dtype=torch.float32,
                                            **kw))
        wdec = codec_ops.decode(b, 1, nbits=16)
        lib = time_ms(lambda: torch.matmul(a, wdec))
        w16, a16 = wdec.to(torch.bfloat16), a.to(torch.bfloat16)
        lib16 = time_ms(lambda: torch.matmul(a16, w16))
        ms_bf16_w = time_ms(lambda: posit_gemm(a, w16, (0, 0, 0), a_fmt=F32, b_fmt=BF16,
                                               out_fmt=F32, compute_dtype=torch.bfloat16))
        nbytes = a.numel() * 4 + b.numel() * 2 + M * N * 4
        rows.append({"M": M, "K": K, "N": N, "ms": ms, "f32_compute_ms": ms_f32,
                     "bf16_weights_ms": ms_bf16_w,
                     "library_ms": lib16, "library_f32_ms": lib, "bytes": nbytes,
                     "bound_ms": bound_ms(nbytes, 2 * M * K * N, "bf16")[0],
                     "bound_f32_ms": bound_ms(nbytes, 2 * M * K * N, "f32")[0]})
        if plain:
            rows[-1]["plain_ms"] = time_ms(
                lambda: posit_gemm_ref(a, b, (0, 1, 0), compute_dtype=torch.bfloat16, **kw),
                windows=3, calls=1)
        del a, b, wdec, w16, a16
        torch.cuda.empty_cache()
    return rows


CROSSOVER_M = (64, 128, 256, 512)   # the sweep that sets LARGE_M


@contextlib.contextmanager
def forced_route(large: bool):
    """``posit_gemm`` on the large-M kernels at any M (``large``) or on the
    kernels below the threshold at any M. A package without the large-M
    kernels has one route and is left as it is."""
    old = getattr(gemm_ops, "LARGE_M", None)
    if old is not None:
        gemm_ops.LARGE_M = 0 if large else 1 << 30
    try:
        yield
    finally:
        if old is not None:
            gemm_ops.LARGE_M = old


def large_gemm_timings() -> list:
    """The GEMM past the decode shapes: p8_0 weights as a prefill calls them
    (f32 activations, bf16 compute) at qwen2.5-14b's four prefill shapes, M =
    4,032 (the long context's prompts) and 1,024 (the paged path's), and the
    crossover sweep at q/o and gate/up, M = 64 to 512, under bf16 compute on
    p8 weights and f32 compute on f32 weights. Each row: ``ms`` as the
    package routes it, and where it has the large-M kernels both routes
    forced (``large_ms``, ``tile64_ms``), beside the bound and one
    torch.matmul in the compute dtype (bf16 on the decoded weight; f32 with
    TF32 off)."""
    cases = [(M, K, N, torch.bfloat16) for M in (LONG_PROMPT, PAGED_PROMPT)
             for K, N in GEMM_KN[:4]]
    cases += [(M, K, N, cd) for cd in (torch.bfloat16, torch.float32) for M in CROSSOVER_M
              for K, N in (GEMM_KN[0], GEMM_KN[2])]
    has_large = hasattr(gemm_ops, "LARGE_M")
    rows = []
    for M, K, N, cd in cases:
        b_fmt = P8_0 if cd == torch.bfloat16 else F32
        a, b, _, _ = make_gemm_inputs(M, K, N, b_fmt, torch.float32, False, False, seed=4)
        kw = dict(a_fmt=F32, b_fmt=b_fmt, out_fmt=F32, compute_dtype=cd)
        call = lambda: posit_gemm(a, b, (0, 0, 0), **kw)  # noqa: E731
        row = {"M": M, "K": K, "N": N, "compute": str(cd).split(".")[-1], "ms": time_ms(call)}
        if has_large:
            for name, large in (("large_ms", True), ("tile64_ms", False)):
                with forced_route(large):
                    row[name] = time_ms(call)
        wdec = (codec_ops.decode(b, 0, nbits=8, out_dtype=torch.bfloat16)
                if b_fmt == P8_0 else b)
        ac = a.to(cd)
        row["library_ms"] = time_ms(lambda: torch.matmul(ac, wdec))
        nbytes = a.numel() * 4 + b.numel() * b.element_size() + M * N * 4
        kind = "bf16" if cd == torch.bfloat16 else "f32"
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * M * K * N, kind)
        rows.append(row)
        del a, b, wdec, ac
        torch.cuda.empty_cache()
    return rows


def quire_timings(M: int, shapes, plain: bool = False) -> list:
    """The quire GEMM as the quire linear calls it (p16_1 x p16_1 -> f32) at
    M rows: device ms beside the bound (bytes, or one int8 tensor-core MAC
    of 2 operations a product) and, as that loop's floor only, a per-product
    CUDA-core loop's (4 int32 operations a product). No single PyTorch call
    sums exactly; the fused posit GEMM at the same shape (f32 accumulation)
    is timed beside it as the price of exactness. The plain version's ms at
    gate/up (3072x8192) if asked."""
    rows = []
    for K, N in shapes:
        a, b, _, _ = make_quire_inputs(M, K, N, P16_1, P16_1, False, False, seed=7)
        kw = dict(a_fmt=P16_1, b_fmt=P16_1, out_fmt=F32)
        ms = time_ms(lambda: posit_quire_gemm(a, b, (1, 1, 1), **kw))
        af = codec_ops.decode(a, 1, nbits=16)
        fused = time_ms(lambda: posit_gemm(af, b, (0, 1, 0), a_fmt=F32, b_fmt=P16_1,
                                           out_fmt=F32))
        products = M * K * N
        nbytes = a.numel() * 2 + b.numel() * 2 + M * N * 4
        rows.append({"M": M, "K": K, "N": N, "ms": ms, "fused_posit_gemm_ms": fused,
                     "bytes": nbytes, "products": products,
                     "bound_ms": bound_ms(nbytes, 2 * products, "int8")[0],
                     "loop_floor_ms": bound_ms(nbytes, QUIRE_OPS_PER_PRODUCT * products,
                                               "int32")[0],
                     "products_per_s": products / (ms * 1e-3)})
        if plain and (K, N) == (3072, 8192):
            rows[-1]["plain_ms"] = time_ms(
                lambda: posit_quire_gemm_ref(a, b, (1, 1, 1), **kw), windows=3, calls=1)
        del a, b, af
        torch.cuda.empty_cache()
    return rows


def softmax_timings() -> dict:
    """The softmax kernel and torch.softmax on the decoded f32 rows, ms."""
    out = {}
    for (R, C), nbits in [(shape, 16) for shape in SOFTMAX_SHAPES] + [(QWEN_LOGITS, 16),
                                                                       (QWEN_LOGITS, 8)]:
        codes = codec_ops.encode(torch.randn((R, C), generator=gen(8), device=DEV) * 3, 1,
                                 nbits=nbits)
        xf = codec_ops.decode(codes, 1, nbits=nbits)
        out[f"{R}x{C} p{nbits}"] = {
            "ms": time_ms(lambda: softmax_ops.softmax(codes, 1, nbits=nbits)),
            "library_ms": time_ms(lambda: torch.softmax(xf, dim=-1)),
            "bound_ms": bound_ms(2 * codes.numel() * nbits // 8, 6.0 * codes.numel(),
                                 "f32")[0]}
    return out


# (name, kv_bits, es, Hq, Hkv, d, S, lengths) of attention_timings: qwen2.5-14b's
# heads with p8_0 KV, every row full, at the served S_max (80) and longer
# caches; one ragged batch; p16_1 KV; phi3-mini-3.8b's heads with p16_1 KV
ATTN_TIMINGS = (
    ("qwen p8 S80", 8, 0, 40, 8, 128, 80, (80,) * 4),
    ("qwen p8 S512", 8, 0, 40, 8, 128, 512, (512,) * 4),
    ("qwen p8 S4096", 8, 0, 40, 8, 128, 4096, (4096,) * 4),
    ("qwen p8 S32768", 8, 0, 40, 8, 128, 32768, (32768,) * 4),
    ("qwen p8 S4096 ragged", 8, 0, 40, 8, 128, 4096, (0, 1, 2048, 4096)),
    ("qwen p16_1 S4096", 16, 1, 40, 8, 128, 4096, (4096,) * 4),
    ("phi3 p16_1 S4096", 16, 1, 32, 32, 96, 4096, (4096,) * 4),
)
COLD_BYTES = 100e6  # distinct caches a timing rotates through, more than L2 holds


def _rotated(tensors: tuple, n: int) -> list:
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def attention_timings() -> list:
    """The attention kernel at each ATTN_TIMINGS case, device ms, read cold as
    a real step reads each layer's cache: every call takes the next of enough
    copies of the cache that their bytes exceed COLD_BYTES. Beside it the
    byte bound (the live codes once, q and out) and one
    scaled_dot_product_attention call on the decoded f32 cache (the same
    rotation), with enable_gqa where this torch has it."""
    import itertools

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, kv_bits, es, Hq, Hkv, d, S, lengths in ATTN_TIMINGS:
        q, k, v, lens = attn_inputs(kv_bits, Hq=Hq, Hkv=Hkv, d=d, S=S, lengths=lengths,
                                    seed=S + 1, es=es)
        live = sum(lengths)
        nbytes = 2 * live * Hkv * d * k.element_size() + 2 * q.numel() * 4 + lens.numel() * 4
        b_ms, by = bound_ms(nbytes, 4.0 * Hq * d * live, "f32")
        caches = _rotated((k, v), 1 + int(COLD_BYTES // (2 * k.numel() * k.element_size())))
        turn = itertools.cycle(caches)

        def kernel():
            kc, vc = next(turn)
            attn_ops.decode_attention(q, kc, vc, lens, es, kv_bits=kv_bits)

        ms = time_ms(kernel)
        n_rot = len(caches)
        del caches, turn
        torch.cuda.empty_cache()
        kd, vd = ((codec_ops.decode(t, es, nbits=kv_bits) if kv_bits else t) for t in (k, v))
        mask = (torch.arange(S, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
        qs = q[:, :, None]
        try:
            sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True)
            gqa = True
        except TypeError:   # a torch without enable_gqa: K/V repeated per q-head
            kd, vd = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kd, vd))
            gqa = False
        lib_caches = _rotated((kd, vd), 1 + int(COLD_BYTES // (2 * kd.numel() * 4)))
        lib_turn = itertools.cycle(lib_caches)

        def library():
            kc, vc = next(lib_turn)
            if gqa:
                sdpa(qs, kc, vc, attn_mask=mask, enable_gqa=True)
            else:
                sdpa(qs, kc, vc, attn_mask=mask)

        rows.append({"case": name, "ms": ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": time_ms(library), "library_enable_gqa": gqa,
                     "bytes": nbytes, "rotated_caches": n_rot,
                     "library_rotated_caches": len(lib_caches)})
        del q, k, v, kd, vd, lib_caches, lib_turn
        torch.cuda.empty_cache()
    return rows


def _cold_ms(fn, tensors: tuple) -> tuple[float, int]:
    """Device ms of ``fn(*copy)`` over rotated copies of ``tensors`` whose
    bytes exceed COLD_BYTES (read cold, as a step reads each layer's cache),
    and the number of copies."""
    import itertools

    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = _rotated(tensors, 1 + int(COLD_BYTES // nbytes))
    turn = itertools.cycle(copies)
    ms = time_ms(lambda: fn(*next(turn)))
    del copies, turn
    torch.cuda.empty_cache()
    return ms, 1 + int(COLD_BYTES // nbytes)


PAGED_TIMED_BT = (16, 1)


def sdpa_ms(q, kd, vd, lens) -> float:
    """One scaled_dot_product_attention call over decoded f32 K/V (B, Hkv,
    S, d) with each row's length as a boolean mask, read cold; enable_gqa
    where this torch has it, else K/V repeated a q-head."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    S, g = kd.shape[2], q.shape[1] // kd.shape[1]
    mask = (torch.arange(S, device=DEV)[None, :] < lens[:, None])[:, None, None, :]
    try:
        sdpa(q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True)
        return _cold_ms(lambda kc, vc: sdpa(q[:, :, None], kc, vc, attn_mask=mask,
                                            enable_gqa=True), (kd, vd))[0]
    except TypeError:
        kd, vd = (t.repeat_interleave(g, dim=1) for t in (kd, vd))
        return _cold_ms(lambda kc, vc: sdpa(q[:, :, None], kc, vc, attn_mask=mask), (kd, vd))[0]


def paged_attention_timings() -> list:
    """The paged kernel read cold at qwen2.5-14b's heads, p8, 4 full rows of
    S = 4,096, at bt 16 and 1 (PAGED_TIMED_BT) over shuffled pools of exactly
    the live pages, beside the dense kernel on the same codes in the same
    run, with the dense rows' bound (the live codes once, q and out)."""
    S, lengths = 4096, (4096,) * 4
    q, k, v, lens = attn_inputs(8, S=S, lengths=lengths, seed=S + 7)
    live = sum(lengths)
    nbytes = 2 * live * QWEN.n_kv * QWEN.hd + 2 * q.numel() * 4 + lens.numel() * 4
    b_ms, by = bound_ms(nbytes, 4.0 * QWEN.n_heads * QWEN.hd * live, "f32")
    dense_ms, n_rot = _cold_ms(
        lambda kc, vc: attn_ops.decode_attention(q, kc, vc, lens, 0, kv_bits=8), (k, v))
    rows = [{"case": f"qwen p8 S{S} dense", "ms": dense_ms, "bound_ms": b_ms, "bound_by": by,
             "bytes": nbytes, "rotated_caches": n_rot}]
    for bt in PAGED_TIMED_BT:
        kp, vp, table = page_cache(k, v, lengths, bt, seed=bt, extra=0)
        ms, n_rot = _cold_ms(lambda kc, vc: attn_ops.decode_attention_paged(
            q, kc, vc, table, lens, 0, kv_bits=8), (kp, vp))
        rows.append({"case": f"qwen p8 S{S} paged bt{bt}", "ms": ms, "dense_ms": dense_ms,
                     "over_dense": ms / dense_ms, "bound_ms": b_ms, "bound_by": by,
                     "bytes": nbytes, "rotated_caches": n_rot})
        del kp, vp, table
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def paged_path_shape_error(q, kp, vp, table, lens) -> float:
    """The paged kernel against its plain version on ``time_kernels``' inputs
    at the paged path's 16-slot shape (p8, bt 16, W 66): within the contract's
    limit and the tight one (phase 4's, max|V| over the live codes), and bit
    for bit the dense kernel on the de-paged cache. Returns the error."""
    S = table.shape[1] * kp.shape[2]
    got = attn_ops.decode_attention_paged(q, kp, vp, table, lens, 0, kv_bits=8)
    plain = attn_ref.posit_decode_attention_paged_ref(q, kp, vp, table, lens, 0, kv_bits=8)
    kd, vd = attn_ref.depage(kp, table), attn_ref.depage(vp, table)
    dense = attn_ops.decode_attention(q, kd, vd, lens, 0, kv_bits=8)
    vmax = float(codec_ref.decode_ref(live_codes(vd, lens), 0, nbits=8).abs().max())
    row = {"case": f"paged path p8 bt{kp.shape[2]} B{q.shape[0]} S{S}",
           "max_abs_err": float((got - plain).abs().max()),
           "limit": 4 * (QWEN.hd + 2 * S) * U * vmax, "tight_limit": TIGHT_ULPS * U * vmax,
           "bit_exact_with_dense": torch.equal(bits(got), bits(dense))}
    DETAILS["paged_attention_path_shape"] = row
    assert row["bit_exact_with_dense"], f"attention {row['case']}: differs from the dense kernel"
    assert row["max_abs_err"] <= min(row["limit"], row["tight_limit"]), \
        f"attention {row['case']}: {row}"
    return row["max_abs_err"]


def time_kernels(launches: dict, errs: dict) -> list:
    """One row per kernel; ``launches`` maps each kernel to its count on the
    path it belongs to."""
    rows = []

    def row(name, source, replaces, ms, plain_ms, nbytes, flops, kind, library_ms):
        b_ms, by = bound_ms(nbytes, flops, kind)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": library_ms})

    # encode: the K (or V) block a prefill of the main path writes, (1, Hkv, 64,
    # hd); a decode step's row is encoded inside the attention kernel
    x = torch.randn((1, QWEN.n_kv, 64, QWEN.hd), generator=gen(2), device=DEV)
    row("posit_encode", "src/repro_torch/csrc/posit_codec.cu",
        "src/repro/kernels/posit_codec/posit_codec.py:77",
        time_ms(lambda: codec_ops.encode(x, 0, nbits=8)),
        time_ms(lambda: codec_ref.encode_ref(x, 0, nbits=8)),
        x.numel() * 5, 0.0, "f32", None)
    # decode: the serve report's KV-cache health read, (L, B, Hkv, S, hd) p8
    c = torch.randint(0, 256, (QWEN.n_layers, 4, QWEN.n_kv, 80, QWEN.hd), generator=gen(3),
                      device=DEV, dtype=torch.int32).to(torch.uint8)
    row("posit_decode", "src/repro_torch/csrc/posit_codec.cu",
        "src/repro/kernels/posit_codec/posit_codec.py:54",
        time_ms(lambda: codec_ops.decode(c, 0, nbits=8)),
        time_ms(lambda: codec_ref.decode_ref(c, 0, nbits=8), windows=3, calls=2),
        c.numel() * 5, 0.0, "f32", None)
    del c
    # gemm: every decode-step linear at 4 slots; the JSON row is the gate/up
    # projection (the largest per-layer weight), the rest go to the details
    shapes = gemm_timings(4, GEMM_KN, plain=True)
    for sh in shapes:
        if (sh["K"], sh["N"]) == (5120, 13824):
            row("posit_gemm", "src/repro_torch/csrc/posit_gemm.cu",
                "src/repro/kernels/posit_gemm/posit_gemm.py:244", sh["ms"], sh["plain_ms"],
                sh["bytes"], 2 * 4 * sh["K"] * sh["N"], "bf16", sh["library_ms"])
    DETAILS["gemm_decode_shapes"] = shapes
    # the mid-M kernel: the 16-slot decode step's gate/up projection (M =
    # 16); every 16- and 32-row decode shape and the 64-token prefill's go
    # to the details
    shapes = gemm_timings(16, GEMM_KN, plain=True)
    for sh in shapes:
        if (sh["K"], sh["N"]) == (5120, 13824):
            row("posit_gemm_mid_tc", "src/repro_torch/csrc/posit_gemm_mid.cu",
                "src/repro/kernels/posit_gemm/posit_gemm.py:244", sh["ms"], sh["plain_ms"],
                sh["bytes"], 2 * 16 * sh["K"] * sh["N"], "bf16", sh["library_ms"])
    DETAILS["gemm_mid16_shapes"] = shapes
    DETAILS["gemm_mid32_shapes"] = gemm_timings(32, GEMM_KN)
    DETAILS["gemm_prefill_shapes"] = gemm_timings(64, GEMM_KN[:-1])
    # the packed variants: the gate/up projection at 4 slots, tensor cores
    # (bf16 compute, the mixed path's) and f32 FMA; every decode and prefill
    # shape beside the unpacked kernel goes to the details
    for cd, name in ((torch.bfloat16, "posit_gemm_packed"),
                     (torch.float32, "posit_gemm_packed_fma")):
        shapes = packed_timings(4, GEMM_KN, cd, plain=True)
        for sh in shapes:
            if (sh["K"], sh["N"]) == (5120, 13824):
                row(name, "src/repro_torch/csrc/posit_gemm.cu",
                    "src/repro/kernels/posit_gemm/posit_gemm.py:68", sh["ms"], sh["plain_ms"],
                    sh["bytes"], 2 * 4 * sh["K"] * sh["N"],
                    "bf16" if cd == torch.bfloat16 else "f32", sh["library_ms"])
        DETAILS[f"{name}_decode_shapes"] = shapes
        DETAILS[f"{name}_prefill_shapes"] = packed_timings(64, GEMM_KN[:-1], cd)
    # p16 weights on the tensor cores (the mixed path's q/k/v/o): the q/o
    # projection at 4 slots; k/v, f32 compute and prefill go to the details
    shapes = p16_timings(plain=True)
    for sh in shapes:
        if (sh["K"], sh["N"]) == (5120, 5120):
            row("posit_gemm_p16", "src/repro_torch/csrc/posit_gemm.cu",
                "src/repro/kernels/posit_gemm/posit_gemm.py:244", sh["ms"], sh["plain_ms"],
                sh["bytes"], 2 * 4 * sh["K"] * sh["N"], "bf16", sh["library_ms"])
    DETAILS["gemm_p16_decode_shapes"] = shapes
    DETAILS["gemm_p16_prefill_shapes"] = p16_timings(64)
    # the large-M kernels: wgmma at the long context's gate/up prefill (p8 B,
    # M = 4,032) beside torch.matmul bf16 on the decoded weight, the FMA tile
    # at the train step's gate/up (f32 B, M = 4,096) beside cuBLAS SGEMM (TF32
    # off), from CUDA events as ``train_timings`` (the profiler's windows have
    # lost cuBLAS records at these sizes); every prefill shape and the
    # crossover sweep go to the details
    for name, M, (K, N), b_fmt, cd in (
            ("posit_gemm_large_tc", LONG_PROMPT, (5120, 13824), P8_0, torch.bfloat16),
            ("posit_gemm_large_fma", TRAIN_M, (3072, 8192), F32, torch.float32)):
        a, b, _, _ = make_gemm_inputs(M, K, N, b_fmt, torch.float32, False, False, seed=4)
        kw = dict(es=(0, 0, 0), a_fmt=F32, b_fmt=b_fmt, out_fmt=F32, activation="none",
                  compute_dtype=cd)
        ms = event_ms(lambda: posit_gemm(a, b, (0, 0, 0), a_fmt=F32, b_fmt=b_fmt, out_fmt=F32,
                                         compute_dtype=cd))
        wdec = codec_ops.decode(b, 0, nbits=8, out_dtype=cd) if b_fmt == P8_0 else b
        ac = a.to(cd)
        row(name, "src/repro_torch/csrc/posit_gemm_large.cu",
            "src/repro/kernels/posit_gemm/posit_gemm.py:244", ms,
            event_ms(lambda: gemm_plain(a, b, None, None, kw), calls=2),
            a.numel() * 4 + b.numel() * b.element_size() + M * N * 4, 2.0 * M * K * N,
            "bf16" if cd == torch.bfloat16 else "f32", event_ms(lambda: torch.matmul(ac, wdec)))
        del a, b, wdec, ac
        torch.cuda.empty_cache()
    DETAILS["gemm_large_timings"] = large_gemm_timings()
    # attention: a decode step of the main path, 4 slots at S_max = 80 (all full)
    q, k, v, lens = attn_inputs(8, S=80, lengths=(80, 80, 80, 80), seed=5)
    kd = codec_ref.decode_ref(k, 0, nbits=8).repeat_interleave(5, dim=1)
    vd = codec_ref.decode_ref(v, 0, nbits=8).repeat_interleave(5, dim=1)
    mask = torch.arange(80, device=DEV)[None, None, None, :] < lens[:, None, None, None]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask))
    live = int(lens.sum())
    nbytes = q.numel() * 4 * 2 + 2 * live * QWEN.n_kv * QWEN.hd + 16
    row("posit_attention", "src/repro_torch/csrc/posit_attention.cu",
        "src/repro/kernels/posit_attention/posit_attention.py:131",
        time_ms(lambda: attn_ops.decode_attention(q, k, v, lens, 0, kv_bits=8)),
        time_ms(lambda: posit_decode_attention_ref(q, k, v, lens, 0, kv_bits=8)),
        nbytes, 4.0 * QWEN.n_heads * QWEN.hd * live, "f32", lib)
    # paged attention: the paged path's decode step at 16 slots, mid-run (1,040
    # positions a row in pages of 16, W 66), read cold; the library call is SDPA
    # on the de-paged decoded f32 cache. The kernel's output on these inputs is
    # held to the plain version within phase 4's limits, its error the row's
    plen = (PAGED_PROMPT + 16,) * PAGED_REQUESTS
    pq, pk, pv, plens = attn_inputs(8, B=PAGED_REQUESTS, S=PAGED_S_MAX, lengths=plen, seed=11)
    kp, vp, table = page_cache(pk, pv, plen, 16, seed=11, extra=0)
    del pk, pv
    errs = dict(errs, posit_attention_paged=max(
        errs["posit_attention_paged"], paged_path_shape_error(pq, kp, vp, table, plens)))
    live = sum(plen)
    nbytes = (pq.numel() * 4 * 2 + 2 * live * QWEN.n_kv * QWEN.hd + plens.numel() * 4
              + table.numel() * 4)
    ms, _ = _cold_ms(lambda kc, vc: attn_ops.decode_attention_paged(pq, kc, vc, table, plens,
                                                                    0, kv_bits=8), (kp, vp))
    pkd, pvd = (codec_ops.decode(attn_ref.depage(t, table), 0, nbits=8) for t in (kp, vp))
    row("posit_attention_paged", "src/repro_torch/csrc/posit_attention.cu",
        "src/repro/kernels/posit_attention/posit_attention.py:131", ms,
        time_ms(lambda: attn_ref.posit_decode_attention_paged_ref(pq, kp, vp, table, plens, 0,
                                                                  kv_bits=8),
                windows=3, calls=2),
        nbytes, 4.0 * QWEN.n_heads * QWEN.hd * live, "f32", sdpa_ms(pq, pkd, pvd, plens))
    del pq, kp, vp, pkd, pvd, table
    DETAILS["paged_attention_timings"] = paged_attention_timings()
    q5, k5, v5, l5 = attn_inputs(8, lengths=(512, 512, 512, 512), seed=6)
    DETAILS["attention_S512_ms"] = time_ms(
        lambda: attn_ops.decode_attention(q5, k5, v5, l5, 0, kv_bits=8))
    del q, k, v, kd, vd, q5, k5, v5
    DETAILS["attention_timings"] = attention_timings()
    # quire GEMM: the decode-step gate/up of phi3 at 4 slots, p16 x p16 -> f32;
    # every phi3 decode and prefill shape goes to the details
    shapes = quire_timings(4, PHI3_KN + (PHI3_LM_HEAD,), plain=True)
    for sh in shapes:
        if (sh["K"], sh["N"]) == (3072, 8192):
            row("posit_quire_gemm", "src/repro_torch/csrc/posit_quire_gemm.cu",
                "src/repro/kernels/posit_quire_gemm/posit_quire_gemm.py:186", sh["ms"],
                sh["plain_ms"], sh["bytes"], 2 * sh["products"], "int8", None)
    DETAILS["quire_decode_shapes"] = shapes
    DETAILS["quire_prefill_shapes"] = quire_timings(32, PHI3_KN)
    # softmax: phi3's logits at 4 slots, (4, 32064) p16_1; the yardstick is
    # torch.softmax on the decoded f32 rows
    R, C = SOFTMAX_SHAPES[-1]
    codes = codec_ops.encode(torch.randn((R, C), generator=gen(8), device=DEV) * 3, 1, nbits=16)
    xf = codec_ops.decode(codes, 1, nbits=16)
    row("posit_softmax", "src/repro_torch/csrc/posit_softmax.cu",
        "src/repro/kernels/posit_softmax/posit_softmax.py:41",
        time_ms(lambda: softmax_ops.softmax(codes, 1, nbits=16)),
        time_ms(lambda: posit_softmax_ref(codes, 1, nbits=16)),
        2 * codes.numel() * 2, 6.0 * codes.numel(), "f32",
        time_ms(lambda: torch.softmax(xf, dim=-1)))
    paper = {}
    for r, c in SOFTMAX_SHAPES[:3]:
        rows_rc = codec_ops.encode(torch.randn((r, c), generator=gen(9), device=DEV), 1, nbits=16)
        paper[f"{r}x{c}"] = time_ms(lambda: softmax_ops.softmax(rows_rc, 1, nbits=16))
    DETAILS["softmax_paper_rows_ms"] = paper
    DETAILS["softmax_timings"] = softmax_timings()
    return rows


# ------------------------------------------- the ISA entry points and moe ----
# (imported inside the functions: kernel_timings.py imports this module with
# older packages, which have none of them)

# the moe configs by name, resolved where they are used: kernel_timings.py
# imports this module with packages that have no moe config
OLMOE, GRANITE = "olmoe-1b-7b", "granite-moe-3b-a800m"
TABLE4_SIZES = (4, 8, 12, 16, 20, 256, 1024)   # benchmarks/bench_table4_gemm.py
GEMV_SIZES = (4, 8, 16, 32, 4096)              # benchmarks/bench_gemv_softmax.py
# (op, n, format) of the dataflow checks and timings: every Table IV GEMM,
# and the GEMVs at the posit formats
DATAFLOW_CASES = tuple(("gemm", n, f) for f in (F32, P16_1, P8_0) for n in TABLE4_SIZES) + \
    tuple(("gemv", n, f) for f in (P16_1, P8_0) for n in GEMV_SIZES)
ALU_OPS = ("posit_add", "posit_sub", "posit_mul")
MOE_PAGE_BYTES = 65536   # 16 tokens of olmoe's 16 KV heads x 128 at p8, K and V


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit patterns: codes as integers, floats by their int32 view."""
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got.dtype == want.dtype and torch.equal(got.to(torch.int64), want.to(torch.int64))


def signed_codes(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """Posit codes as two's-complement integers, which order as the values."""
    c = codes.cpu().to(torch.int64)
    return torch.where(c >= 1 << (nbits - 1), c - (1 << nbits), c)


def posit_in_bound(name: str, got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor,
                   fmt) -> int:
    """Posit codes ``got`` each the rounding of some value within ``tol`` of
    the f32 ``want``: between the codes of ``want - tol`` and ``want + tol``.
    Returns the largest distance in code steps from the code of ``want``."""
    enc = lambda x: signed_codes(codec_ref.encode_ref(x, fmt.es, nbits=fmt.nbits),  # noqa: E731
                                 fmt.nbits)
    g = signed_codes(got, fmt.nbits)
    lo, hi = enc(want - tol), enc(want + tol)
    assert bool(((g >= lo) & (g <= hi)).all()), f"{name}: a posit result outside the GEMM bound"
    return int((g - enc(want)).abs().max())


def check_alu_fcvt() -> dict:
    """The true-posit ALU (``core/alu.py``: element-wise torch ops on the
    card) on every p8 pair and 2^18 sampled p16 pairs at es 0-3, a chain of
    quire ops (qclr, qma, qms, qneg, qround) over 4,096 quires of each
    width, and the eight fcvt ops (``core/convert.py``: the codec kernels)
    on every p8 and p16 code at es 0-3 (every es_out for posit -> posit) and
    on a float sweep: each bit for bit the same call on the CPU (which
    tests/test_torch_alu_convert.py holds bit for bit to the reference)."""
    from repro_torch.core import alu, convert

    a8 = torch.arange(256, dtype=torch.uint8).repeat_interleave(256)
    b8 = torch.arange(256, dtype=torch.uint8).repeat(256)
    g = torch.Generator().manual_seed(40)
    a16 = torch.randint(0, 1 << 16, (1 << 18,), generator=g).to(torch.int32).to(torch.uint16)
    b16 = torch.randint(0, 1 << 16, (1 << 18,), generator=g).to(torch.int32).to(torch.uint16)
    alu_values = 0
    for es in range(4):
        for op in ALU_OPS:
            for n, a, b in ((8, a8, b8), (16, a16, b16)):
                want = getattr(alu, op)(a, b, n, es)
                got = getattr(alu, op)(a.to(DEV), b.to(DEV), n, es)
                assert same_bits(got, want), f"{op} p{n} es {es}: card and CPU differ"
                alu_values += want.numel()
    quires = 0
    for n in (8, 16):
        rows, steps = 4096, 32
        a = torch.randint(0, 1 << n, (steps, rows), generator=g).to(torch.int32)
        b = torch.randint(0, 1 << n, (steps, rows), generator=g).to(torch.int32)
        dt = torch.uint8 if n == 8 else torch.uint16
        a, b = a.to(dt), b.to(dt)
        qc, qg = alu.qclr((rows,), n, device="cpu"), alu.qclr((rows,), n, device=DEV)
        for t in range(steps):
            op = (alu.qma, alu.qms)[t % 2]
            qc = op(qc, a[t], b[t], n, t % 4)
            qg = op(qg, a[t].to(DEV), b[t].to(DEV), n, t % 4)
            if t % 7 == 6:
                qc, qg = alu.qneg(qc, n), alu.qneg(qg, n)
        assert same_bits(qg, qc), f"p{n} quire limbs: card and CPU differ"
        for es in range(4):
            assert same_bits(alu.qround(qg, n, es), alu.qround(qc, n, es)), \
                f"p{n} qround es {es}: card and CPU differ"
        quires += rows
    before = dict(kernels.LAUNCHES)
    fcvt_calls = 0
    for name, n in (("fcvt_s_p8", 8), ("fcvt_s_p16", 16), ("fcvt_p8_p8", 8),
                    ("fcvt_p8_p16", 16), ("fcvt_p16_p8", 8), ("fcvt_p16_p16", 16)):
        codes = torch.arange(1 << n, dtype=torch.int32).to(torch.uint8 if n == 8
                                                            else torch.uint16)
        fn = getattr(convert, name)
        for es in range(4):
            for args in ([(es,)] if name.startswith("fcvt_s_") else
                         [(es, eo) for eo in range(4)]):
                assert same_bits(fn(codes.to(DEV), *args), fn(codes, *args)), \
                    f"{name}{args}: card and CPU differ"
                fcvt_calls += 1
    mags = torch.ldexp(1.0 + torch.rand(1 << 16, generator=g),
                       torch.randint(-140, 121, (1 << 16,), generator=g))
    sweep = torch.cat([mags * torch.where(torch.rand(1 << 16, generator=g) < 0.5, -1.0, 1.0),
                       torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                                     1e-45, -1e-40, 2.0 ** 113, -(2.0 ** 113), 2.0 ** 49])])
    for name in ("fcvt_p8_s", "fcvt_p16_s"):
        for es in range(4):
            fn = getattr(convert, name)
            assert same_bits(fn(sweep.to(DEV), es), fn(sweep, es)), \
                f"{name} es {es}: card and CPU differ on the float sweep"
            fcvt_calls += 1
    codec_launches = {k: kernels.LAUNCHES[k] - before[k] for k in ("posit_decode",
                                                                   "posit_encode")}
    assert all(v > 0 for v in codec_launches.values()), codec_launches
    return {"alu_values": alu_values, "alu_bit_identical": True, "quires": quires,
            "quire_ops_bit_identical": True, "fcvt_calls": fcvt_calls,
            "fcvt_bit_identical": True, "fcvt_codec_launches": codec_launches}


def table4_operands(n: int, fmt, seed: int = 0, x_only: bool = False):
    """bench_table4_gemm.py's operands on the card: normal (n, n) A and B
    (a GEMV's x of (n,)), encoded to ``fmt``."""
    g = gen(seed)
    a = torch.randn((n, n), generator=g, device=DEV)
    b = torch.randn((n,) if x_only else (n, n), generator=g, device=DEV)
    if isinstance(fmt, PositFmt):
        a, b = (codec_ops.encode(t, fmt.es, nbits=fmt.nbits) for t in (a, b))
    return a, b


def check_dataflows() -> dict:
    """``posit_dot``'s fused and unfused dataflows at Table IV's sizes (F32,
    P16_1, P8_0; n = 4 to 1,024) and ``posit_gemv`` at the paper's GEMV
    sizes, on the card against the plain versions on the CPU: with an f32
    rd within the GEMM bound of the plain version's sums; with rd the
    operands' format, each code the rounding of a value within that bound
    (near a cancellation an f32 sum in another order moves a small result
    by many posit steps). The fused dataflow makes one ``posit_gemm`` call
    and no codec call (past LARGE_M rows that call's large-M route decodes
    posit A and B to bf16 in passes of its own: ``dataflow_timings`` names
    every kernel); the unfused one decodes each posit operand with the
    decode kernel, then one GEMM call on the floats, then the encode kernel
    for a posit rd. Whether the two give the same bits on the card is
    recorded."""
    from repro_torch.core.dot import format_pair_plan, posit_dot, posit_gemv
    from repro_torch.core.pcsr import OperandSlots

    worst, ratio, worst_steps, same, cases = 0.0, 0.0, 0, 0, 0
    launches = {}
    for op, n, fmt in DATAFLOW_CASES:
        gemv = op == "gemv"
        fn = posit_gemv if gemv else posit_dot
        cd = format_pair_plan(fmt, fmt).compute_dtype
        a, b = table4_operands(n, fmt, seed=n, x_only=gemv)
        av = operand_values(a.cpu(), fmt)
        bv = operand_values(b.cpu(), fmt)
        bv = bv[:, None] if gemv else bv
        tol = 2 * n * U * torch.matmul(av.to(cd).float().abs(), bv.abs())
        out = {}
        for impl in ("fused", "unfused") if isinstance(fmt, PositFmt) else ("fused",):
            want = None
            for rd in (F32,) if gemv else (F32, fmt):
                slots = OperandSlots(rs1=fmt, rs2=fmt, rd=rd)
                kernels.reset_launches()
                got = fn(a, b, slots, impl=impl)
                torch.cuda.synchronize()
                key = f"{op}/{n}/{fmt.name}/{impl}/rd_{rd.name}"
                launches[key] = {k: v for k, v in kernels.LAUNCHES.items() if v}
                assert launches[key].get("posit_decode", 0) == (2 if impl == "unfused" else 0), \
                    (key, launches[key])
                got = got.cpu().reshape(n, -1)
                if rd == F32:
                    want = fn(a.cpu(), b.cpu(), slots, impl=impl).reshape(n, -1)
                    res = gemm_bound_check(key, got, want, av, lambda sl: bv[:, sl], cd, n)
                    worst = max(worst, res["max_abs_err"])
                    ratio = max(ratio, res["err_over_bound"])
                else:
                    worst_steps = max(worst_steps, posit_in_bound(
                        key, got, want, tol + 8 * U * want.abs(), fmt))
                out[(impl, rd.name)] = got
                cases += 1
        if isinstance(fmt, PositFmt):
            for rd in (F32,) if gemv else (F32, fmt):
                same += int(same_bits(out[("fused", rd.name)], out[("unfused", rd.name)]))
    DETAILS["dataflow_launches"] = launches
    return {"cases": cases, "max_abs_err": worst, "err_over_bound": ratio,
            "max_posit_steps_from_plain_f32": worst_steps, "fused_equals_unfused_pairs": same}


def dataflow_timings() -> dict:
    """Fused against unfused ``posit_dot`` at Table IV's sizes (rd the
    operands' format, as bench_table4_gemm.py calls ``gemm``) and
    ``posit_gemv`` (f32 rd, bench_gemv_softmax.py's slots): each call's
    device time (every kernel it launches, torch.profiler) and its time
    from CUDA events around back-to-back calls (the host's launches
    included: at these sizes the dataflows' extra passes cost launches more
    than bytes), each kernel's launches and device us a call (under
    ``<impl>_kernels``: the large-M route's bf16 decode passes of a fused
    call show there), and unfused over fused for both: the card's answer
    to the paper's 2.54x."""
    from repro_torch.core.dot import posit_dot, posit_gemv
    from repro_torch.core.pcsr import OperandSlots

    rows = []
    for op, n, fmt in DATAFLOW_CASES:
        gemv = op == "gemv"
        a, b = table4_operands(n, fmt, seed=n, x_only=gemv)
        slots = OperandSlots(rs1=fmt, rs2=fmt, rd=F32 if gemv else fmt)
        row = {"op": op, "n": n, "fmt": fmt.name}
        for impl in ("fused", "unfused") if isinstance(fmt, PositFmt) else ("fused",):
            fn = ((lambda i=impl: posit_gemv(a, b, slots, impl=i)) if gemv else
                  (lambda i=impl: posit_dot(a, b, slots, impl=i)))
            row[f"{impl}_kernels"] = {}
            row[f"{impl}_device_ms"] = time_ms(fn, kernels_out=row[f"{impl}_kernels"])
            row[f"{impl}_event_ms"] = event_ms(fn, windows=5, calls=20)
        if "unfused_device_ms" in row:
            row["unfused_over_fused_device"] = row["unfused_device_ms"] / row["fused_device_ms"]
            row["unfused_over_fused_event"] = row["unfused_event_ms"] / row["fused_event_ms"]
        rows.append(row)
    return {"rows": rows}


def moe_gemm_launches(cfg, steps: int, prefills: int) -> dict:
    """The GEMM launches of ``steps`` decode steps at 4 slots and
    ``prefills`` 64-token prompts on a moe model: a layer's four attention
    projections, its router and three products an expert, at M = 4 (the
    router, attention) or C = 8 rows (the experts) in a decode step, on the
    decode tile (``posit_gemm``); at M = 64 or C = 16 rows in a prefill, on
    the mid-M kernel; lm_head at M = 4 a step and at one row a prefill (the
    decode tile)."""
    per_layer = 4 + 1 + 3 * cfg.n_experts
    return {"posit_gemm": steps * (cfg.n_layers * per_layer + 1) + prefills,
            "posit_gemm_mid_tc": prefills * cfg.n_layers * per_layer}


def run_moe_path() -> tuple[dict, dict]:
    """olmoe-1b-7b at full width and depth (16 layers, d 2,048, 64 experts
    top-8, d_ff 1,024), random weights from seed 0, P8_SERVE, 8 requests
    (prompt 64, gen 16, 4 slots, greedy) through the continuous-batching
    engine (``serve``): every expert product on the GEMM kernel (the decode
    tile at C = 8 rows, the mid-M kernel at a 64-token prefill's C = 16),
    counted exactly."""
    events = []
    kernels.reset_launches()
    olmoe = get_arch(OLMOE)
    report = serve(OLMOE, policy="p8-serve", max_slots=4, requests=8, prompt_len=64,
                   gen=16, seed=0, device="cuda", emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert report["requests"] == 8, report["requests"]
    assert all(n == 16 for n in report["completion_tokens"].values()), report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the moe path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the KV cache"
    run = report["kernel_launches"]
    want = moe_gemm_launches(olmoe, report["decode_steps"], 8)
    for k, v in want.items():
        assert run[k] == v, f"moe path: {run[k]} {k} launches, {v} expected ({run})"
    assert run["posit_attention"] == report["decode_steps"] * olmoe.n_layers, run
    DETAILS["moe_serve_events"] = events
    return report, launches


def run_moe_paged(model, params, recorded) -> dict:
    """olmoe-1b-7b P8_SERVE (``model``, ``params``): ``profile_decode``'s 4
    requests (prompt 64, gen PROFILE_GEN) served by the paged engine at 4
    slots (pages of 16 tokens), its decode step captured, against the slot
    grid's captured run of the same requests in that profile
    (``recorded``): the same tokens and every decode step's logits bit for
    bit."""
    from repro_torch.core.pcsr import P8_SERVE as pol
    from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine as Paged

    olmoe = get_arch(OLMOE)
    eng = Paged(model, params, pol, max_slots=4, S_max=64 + PROFILE_GEN,
                page_bytes=MOE_PAGE_BYTES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tokens, seen = served_recorded(eng, profile_requests(olmoe, 4, 64))
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    captured = type(eng._decode).__name__ == "CapturedStep"
    steps = eng.steps
    del eng
    torch.cuda.empty_cache()
    assert captured, "moe paged: the decode step was not captured"
    g_tokens, g_seen = recorded
    assert tokens == g_tokens, "moe: paged tokens differ from the grid's"
    assert_bit_identical(seen, g_seen, "moe: paged against grid at 4 slots")
    assert launches.get("posit_attention", 0) == 0 and launches["posit_attention_paged"] > 0
    return {"bit_identical_steps": len(seen), "tokens_equal": True, "decode_steps": steps,
            "wall_s": wall, "launches": launches}


# ------------------------------------------------------- the whisper path ----
# (imported inside the functions, as the moe section's: kernel_timings.py
# imports this module with packages that have no whisper family)

WHISPER = "whisper-medium"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 4, 32, 32


def whisper_gemm_launches(cfg, steps: int) -> dict:
    """The GEMM, attention and encode launches of a static whisper run of
    ``steps`` decode steps (the teacher-forced prompt's and the greedy
    ones): frame_proj and 6 linears an encoder layer, then 2 cross k/v
    linears a decoder layer, at B * T rows (the large-M route), the cross
    K/V's 2 encodes a layer; a decode step's 8 linears a layer (self q/k/v/o,
    cross q/o, up, down) at 4 rows on the decode tile and 2 attention
    launches a layer (the self append, the cross read). The logits are the
    tied table's ``torch.matmul``."""
    return {"posit_gemm_large_tc": 1 + 6 * cfg.enc_layers + 2 * cfg.n_layers,
            "posit_encode": 2 * cfg.n_layers,
            "posit_gemm": steps * 8 * cfg.n_layers,
            "posit_attention": steps * 2 * cfg.n_layers}


def whisper_inputs(cfg, seed: int = 0) -> tuple:
    """A static batch's prompts and frames, drawn as ``serve_static`` draws
    them: (WHISPER_BATCH, WHISPER_PROMPT) tokens, then (B, T, D) frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT))
    frames = rng.normal(0, 1, (WHISPER_BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return tokens, torch.from_numpy(frames)


def check_small_whisper(policy=P8_SERVE, bound: float = 0.05, prompt_len: int = 8,
                        greedy: int = 4) -> dict:
    """The reduced whisper-medium (2 + 2 layers, 24 frames, 4 heads over 2
    K/V heads, head_dim 32) on the card against the same model on the CPU,
    the same seed-made weights and frames: ``init_cache`` (the encoder and
    the cross K/V) then ``prompt_len`` teacher-forced and ``greedy`` greedy
    decode steps, logits within ``bound`` (P8_SERVE's, as phase 5's reduced
    models) and the same greedy token wherever the CPU's top-2 margin
    exceeds twice the bound; the cross codes' distance reported."""
    from repro_torch.models.registry import build_model as build

    cfg = get_arch(WHISPER).reduced()
    cpu_model, gpu_model = build(cfg, device="cpu"), build(cfg, device="cuda")
    params_cpu = cpu_model.init(0, policy)
    params_gpu = _to(params_cpu, DEV)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, prompt_len)).astype(np.int32))
    frames = torch.from_numpy(rng.normal(0, 1, (2, cfg.enc_frames, cfg.d_model))
                              .astype(np.float32))
    S_max = prompt_len + greedy
    cc = cpu_model.init_cache(params_cpu, {"frames": frames}, policy, S_max)
    before = dict(kernels.LAUNCHES)
    cg = gpu_model.init_cache(params_gpu, {"frames": frames}, policy, S_max)
    # the encoder's and the cross K/V's launches (48 rows: the mid-M kernel)
    enc_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before
                    if kernels.LAUNCHES[k] != before[k]}
    assert enc_launches.get("posit_encode") == 2 * cfg.n_layers, enc_launches
    d = (cg["cross"]["k"].cpu().to(torch.int32) - cc["cross"]["k"].to(torch.int32)) & 255
    code_dist = torch.minimum(d, 256 - d)
    worst, agree, clear, tok = 0.0, 0, 0, None
    for step in range(prompt_len + greedy):
        t = toks[:, step] if step < prompt_len else tok
        lc, cc = cpu_model.decode_step(params_cpu, t, cc, policy)
        lg, cg = gpu_model.decode_step(params_gpu, t.to(DEV), cg, policy)
        err = float((lg.cpu() - lc).abs().max())
        worst = max(worst, err)
        assert torch.isfinite(lg).all() and err <= bound, f"reduced whisper: logits off by {err}"
        if step >= prompt_len - 1:
            top2 = torch.topk(lc, 2, dim=-1).values
            margin_clear = (top2[:, 0] - top2[:, 1]) > 2 * bound
            same = lg.cpu().argmax(-1) == lc.argmax(-1)
            assert bool(same[margin_clear].all()), "whisper: greedy tokens differ on a clear step"
            agree += int(same.sum())
            clear += int(margin_clear.sum())
        tok = lc.argmax(-1).to(torch.int32)
    assert torch.equal(cg["lens"].cpu(), cc["lens"]) and torch.equal(cg["self"]["len"].cpu(),
                                                                     cc["self"]["len"])
    return {"arch": cfg.name, "policy": policy.describe(), "prompt": [2, prompt_len],
            "greedy_steps": greedy, "max_logit_err": worst, "bound": bound,
            "greedy_agree": agree, "margin_clear": clear, "init_cache_launches": enc_launches,
            "cross_k_max_code_distance": int(code_dist.max()),
            "cross_k_codes_differing": int((code_dist > 0).sum()),
            "cross_k_codes": code_dist.numel()}


def run_whisper_path() -> tuple[dict, dict]:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d 1,024, 16 heads over 16 K/V heads, head_dim 64, d_ff 4,096,
    vocab 51,865, 1,500 frames), random weights from seed 0, P8_SERVE,
    through ``serve_static``: a batch of 4, the encoder over seeded frames,
    a 32-token prompt teacher-forced through the captured decode step, then
    32 greedy tokens; every launch counted exactly
    (``whisper_gemm_launches``)."""
    from repro_torch.launch.serve import serve_static

    cfg = get_arch(WHISPER)
    events = []
    kernels.reset_launches()
    report = serve_static(WHISPER, policy="p8-serve", batch=WHISPER_BATCH,
                          prompt_len=WHISPER_PROMPT, gen=WHISPER_GEN, seed=0, device="cuda",
                          emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert report["mode"] == "static" and report["nonfinite_logit_rows"] == 0, report
    assert report["kv_nar_codes"] == 0, "NaR codes in the whisper K/V cache"
    assert len(report["sample_tokens"]) == 8
    # the run's own launches (the report's: after the weights' quantization,
    # before the cache's health read), exactly as counted
    run = report["kernel_launches"]
    want = whisper_gemm_launches(cfg, WHISPER_PROMPT + WHISPER_GEN - 1)
    for k, v in want.items():
        assert run[k] == v, f"whisper path: {run[k]} {k} launches, {v} expected"
    others = {k: v for k, v in run.items() if v and k not in want}
    assert not others, f"whisper path: launches of other kernels {others}"
    DETAILS["whisper_serve_events"] = events
    return report, launches


@contextlib.contextmanager
def recorded_binds(seen: list, steps: dict, *, eager: bool = False):
    """Static mode's ``serve.bind_step`` replaced, inside the block, by the
    shipped one (or, ``eager``, by the step itself, run op by op) with every
    call's logits cloned into ``seen``; the bound step and its arguments
    kept in ``steps``."""
    from repro_torch.launch import serve as serve_mod

    shipped = serve_mod.bind_step

    def rebind(decode, args, state, device):
        step = decode if eager else shipped(decode, args, state, device)
        steps.update(step=step, args=args)

        def call(*a):
            out = step(*a)
            seen.append(out[0].clone())
            return out
        return call

    serve_mod.bind_step = rebind
    try:
        yield
    finally:
        serve_mod.bind_step = shipped


def whisper_graph_vs_eager(model, params) -> dict:
    """The static whisper batch (``whisper_inputs``) generated twice on one
    set of params: the decode step captured (``bind_step``, as served) and
    run eagerly op by op. Every step's logits (the prompt's 32 and the
    greedy ones) bit for bit, the tokens, both caches (self and cross K/V,
    the lengths, ``lens``, ``pos``) bit for bit, the launch counts equal.
    Then the captured step's time: ``profile_steps`` steps timed on the
    host clock and again under torch.profiler (device time and idle share,
    kernels by name), and the encoder's and the cross K/V's time."""
    from repro_torch.launch.serve import generate_static
    from repro_torch.models import encdec

    cfg = model.cfg
    tokens, frames = whisper_inputs(cfg)
    runs = {}
    for name in ("graph", "eager"):
        seen, steps = [], {}
        kernels.reset_launches()
        with recorded_binds(seen, steps, eager=name == "eager"):
            run = generate_static(model, params, P8_SERVE, tokens, WHISPER_GEN, frames=frames)
        torch.cuda.synchronize()
        runs[name] = (run, seen, dict(kernels.LAUNCHES), steps)
    (g, g_seen, g_launch, bound), (e, e_seen, e_launch, _) = runs["graph"], runs["eager"]
    g_step = bound["step"]
    assert type(g_step).__name__ == "CapturedStep", "the whisper step was not captured"
    assert_bit_identical(g_seen, e_seen, "whisper: graph against eager")
    assert torch.equal(g["tokens"], e["tokens"]), "whisper: graph and eager tokens differ"
    for c in ("self", "cross"):
        for kv in ("k", "v", "len"):
            assert torch.equal(g["cache"][c][kv], e["cache"][c][kv]), f"whisper {c} {kv}"
    for k in ("lens", "pos"):
        assert torch.equal(g["cache"][k], e["cache"][k]), f"whisper {k}"
    assert g_launch == e_launch, (g_launch, e_launch)
    _, tok, cache = bound["args"]     # the captured step's token row and cache
    n_compared = len(g_seen)
    del runs, g_seen, e_seen
    torch.cuda.empty_cache()

    # the captured step, as the static loop calls it: the token row written,
    # one replay, the greedy token taken (the replays past S_max write no row
    # and attend over S_max positions: a full step's work)
    def loop(n):
        for _ in range(n):
            tok.copy_(g["tokens"][:, -1])
            logits, _ = g_step(params, tok, cache)
            torch.argmax(logits, dim=-1)

    from torch.profiler import ProfilerActivity

    n = 8
    loop(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(n)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    seen = {}

    def window():
        seen["before"] = dict(kernels.LAUNCHES)   # a lost window is run again
        loop(n)

    _, dev, _ = whole_window(window, ProfilerActivity.CPU, ProfilerActivity.CUDA)
    before = seen["before"]
    per_step = {k: (kernels.LAUNCHES[k] - before[k]) / n for k in before
                if kernels.LAUNCHES[k] != before[k]}
    by_name: dict = {}
    for ev in dev:
        us, c = by_name.get(kernel_name(ev.name), (0.0, 0))
        by_name[kernel_name(ev.name)] = (us + ev.device_time_total, c + 1)
    busy_us = sum(us for us, _ in by_name.values()) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the posit GEMM's kernels (not the tied logits' cuBLAS call) and attention's
    gemm_re = re.compile(r"^(tc_gemm_kernel|gemv_kernel|gemm_kernel|mid_gemm_kernel)<")
    group_ms = {"gemm": sum(us for k, (us, _) in by_name.items() if gemm_re.match(k)) / n / 1e3,
                "attention": sum(us for k, (us, _) in by_name.items()
                                 if k.startswith("attn_kernel")) / n / 1e3}
    frames_dev = frames.to(DEV)
    encoder_ms = event_ms(lambda: encdec.encode(params, frames_dev, cfg, P8_SERVE))
    cache_ms = event_ms(lambda: encdec.init_dec_cache(params, frames_dev, cfg, P8_SERVE,
                                                      WHISPER_PROMPT + WHISPER_GEN))
    out = {"decode_steps_compared": n_compared, "bit_identical": True, "launches_equal": True,
           "tokens": [WHISPER_BATCH, WHISPER_GEN], "captured": True,
           "graph": {"prefill_s": g["prefill_s"], "compile_s": g["compile_s"],
                     "decode_tok_per_s": WHISPER_BATCH * g["timed_steps"] / g["decode_s"]},
           "eager": {"prefill_s": e["prefill_s"],
                     "decode_tok_per_s": WHISPER_BATCH * e["timed_steps"] / e["decode_s"]},
           "step_ms": step_ms, "device_busy_ms_per_step": busy_us / 1e3,
           "device_idle_share": max(0.0, 1 - busy_us / (step_ms * 1e3)),
           "decode_tok_per_s": WHISPER_BATCH / step_ms * 1e3,
           "launches_per_step": per_step,
           "kernels_per_step": sum(c for _, c in by_name.values()) / n,
           "gemm_ms_per_step": group_ms["gemm"], "attention_ms_per_step": group_ms["attention"],
           "encoder_ms": encoder_ms, "init_dec_cache_ms": cache_ms,
           "top": [{"name": k[:90], "device_us_per_step": us / n, "calls_per_step": c / n}
                   for k, (us, c) in top[:12]]}
    assert per_step.get("posit_gemm") == 8 * cfg.n_layers, per_step
    assert per_step.get("posit_attention") == 2 * cfg.n_layers, per_step
    assert per_step.get("posit_encode", 0) == 0, per_step
    return out


def whisper_timings() -> list:
    """Phase 6's rows of the whisper path's new shapes, beside the bound and
    a PyTorch call: the cross read (attention's no-append mode, 4 rows of
    16 q-heads over 16 K/V heads, d 64, all 1,500 encoder positions, p8,
    read cold) against SDPA on the decoded f32 cache, and the encoder's up
    projection (6,000 x 1,024 x 4,096, p8 B, bias and gelu fused, the
    wgmma route) against torch.matmul bf16 on the decoded weight (CUDA
    events, as the large-M rows); each with its plain version's time."""
    cfg = get_arch(WHISPER)
    rows = []
    T = cfg.enc_frames
    lengths = (T,) * WHISPER_BATCH
    q, k, v, lens = attn_inputs(8, B=WHISPER_BATCH, Hq=cfg.n_heads, Hkv=cfg.n_kv, d=cfg.hd,
                                S=T, lengths=lengths, seed=21)
    live = sum(lengths)
    nbytes = 2 * live * cfg.n_kv * cfg.hd + 2 * q.numel() * 4 + lens.numel() * 4
    b_ms, by = bound_ms(nbytes, 4.0 * cfg.n_heads * cfg.hd * live, "f32")
    ms, n_rot = _cold_ms(lambda kc, vc: attn_ops.decode_attention(q, kc, vc, lens, 0, kv_bits=8),
                         (k, v))
    kd, vd = (codec_ops.decode(t, 0, nbits=8) for t in (k, v))
    rows.append({"case": "whisper cross read B4 16/16 d64 S1500 p8", "ms": ms, "bound_ms": b_ms,
                 "bound_by": by, "bytes": nbytes, "rotated_caches": n_rot,
                 "plain_ms": time_ms(lambda: posit_decode_attention_ref(q, k, v, lens, 0,
                                                                        kv_bits=8),
                                     windows=3, calls=2),
                 "library_ms": sdpa_ms(q, kd, vd, lens)})
    del q, k, v, kd, vd
    M, K, N = WHISPER_BATCH * T, cfg.d_model, cfg.d_ff
    a, b, bi, _ = make_gemm_inputs(M, K, N, P8_0, torch.float32, True, False, seed=22)
    kw = dict(es=(0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32, activation="gelu",
              compute_dtype=torch.bfloat16)
    ms = event_ms(lambda: posit_gemm(a, b, (0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32,
                                     bias=bi, activation="gelu", compute_dtype=torch.bfloat16))
    wdec = codec_ops.decode(b, 0, nbits=8, out_dtype=torch.bfloat16)
    a16 = a.to(torch.bfloat16)
    nbytes = a.numel() * 4 + b.numel() + N * 4 + M * N * 4
    b_ms, by = bound_ms(nbytes, 2.0 * M * K * N, "bf16")
    rows.append({"case": "whisper encoder up M6000 1024x4096 p8 bias gelu", "ms": ms,
                 "bound_ms": b_ms, "bound_by": by, "bytes": nbytes,
                 "plain_ms": event_ms(lambda: gemm_plain(a, b, bi, None, kw), calls=2),
                 "library_ms": event_ms(lambda: torch.matmul(a16, wdec))})
    del a, b, bi, wdec, a16
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ the gemma3 path ----

GEMMA3 = "gemma3-4b"
# 4 requests of 1,536 prompt tokens and 64 generated at 4 slots, S_max 1,600:
# every local layer's 1,024-row buffer wraps in prefill and is written
# inside it in decode; static mode 4 x (1,536 + 16)
G3_SLOTS, G3_PROMPT, G3_GEN, G3_STATIC_GEN = 4, 1536, 64, 16
# (part, K, N, activation, residual) of a gemma3-4b layer's linears
G3_LINEARS = (("q", 2560, 2048, "none", False), ("k/v", 2560, 1024, "none", False),
              ("o", 2048, 2560, "none", True), ("gate", 2560, 10240, "silu", False),
              ("up", 2560, 10240, "none", False), ("down", 10240, 2560, "none", True))
G3_KN = tuple(dict.fromkeys((K, N) for _, K, N, _, _ in G3_LINEARS))


def gemma3_launches(cfg, steps: int, prefills: int) -> dict:
    """The kernel launches of a gemma3 run of ``steps`` decode steps and
    ``prefills`` prefill calls (1,536 tokens a row): a decode step's 7
    linears a layer on the decode tile and one attention launch a layer (the
    row's encode and write inside it: no encode launch); a prefill's 7
    linears a layer on the wgmma kernel and its K and V blocks encoded a
    layer. The tied read-out is ``torch.matmul``, no GEMM launch."""
    return {"posit_gemm": steps * 7 * cfg.n_layers,
            "posit_attention": steps * cfg.n_layers,
            "posit_gemm_large_tc": prefills * 7 * cfg.n_layers,
            "posit_encode": prefills * 2 * cfg.n_layers}


def assert_gemma3_launches(run: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        assert run[k] == v, f"{what}: {run[k]} {k} launches, {v} expected ({run})"
    others = {k: v for k, v in run.items() if v and k not in want}
    assert not others, f"{what}: launches of other kernels {others}"


def run_gemma3_path() -> tuple[dict, dict]:
    """gemma3-4b at full width and depth (34 layers, 5 local of window 1,024
    (RoPE base 1e4) to 1 global (1e6), d 2,560, 8 q-heads over 4 KV heads,
    head_dim 256, d_ff 10,240, a tied 262,144-word vocabulary), random
    weights from seed 0, P8_SERVE, 4 requests of 1,536 prompt tokens and 64
    generated, 4 slots, greedy, through ``serve`` (continuous): every launch
    of the run counted exactly (``gemma3_launches``)."""
    events = []
    cfg = get_arch(GEMMA3)
    kernels.reset_launches()
    report = serve(GEMMA3, policy="p8-serve", max_slots=G3_SLOTS, requests=G3_SLOTS,
                   prompt_len=G3_PROMPT, gen=G3_GEN, seed=0, device="cuda", emit=events.append)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    assert report["requests"] == G3_SLOTS, report["requests"]
    assert all(n == G3_GEN for n in report["completion_tokens"].values()), \
        report["completion_tokens"]
    assert report["nonfinite_logit_rows"] == 0, "non-finite logits on the gemma3 path"
    assert report["kv_nar_codes"] == 0, "NaR codes in the gemma3 KV cache"
    assert report["decode_steps"] == G3_GEN - 1, report["decode_steps"]
    assert_gemma3_launches(report["kernel_launches"],
                           gemma3_launches(cfg, report["decode_steps"], G3_SLOTS), "gemma3 path")
    DETAILS["gemma3_serve_events"] = events
    return report, launches


def gemma3_graph_vs_eager() -> dict:
    """The same shape of run (4 x (1,536 + 64), other prompts) through the
    grid engine as shipped, its decode step one captured CUDA graph, and its
    ``EagerTwin`` on one set of params (``profile_decode``: every step's
    logits bit for bit across the windows' wrap, the same tokens and launch
    counts); each decode step exactly 238 GEMM launches, 34 attention
    launches and no encode launch; the profiled step's device ms by group,
    and the tied read-out (``embedding_logits``, 4 rows over the f32 (262,144,
    2,560) table) timed alone beside its byte bound."""
    from repro_torch.models.layers import embedding_logits

    cfg = get_arch(GEMMA3)
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    prof = profile_decode(cfg, P8_SERVE, prompt_len=G3_PROMPT, gen=G3_GEN, slots=G3_SLOTS,
                          model=model, params=params)
    per_step = prof["launches_per_step"]
    want = gemma3_launches(cfg, 1, 0)
    assert per_step["posit_gemm"] == want["posit_gemm"] == 238, per_step
    # two RoPE bases: two arange kernels a step
    assert_kv_write_fused(prof, cfg, "gemma3", rope_bases=2)
    prof["index_kernels"] = {n[:160]: c / prof["profiled_steps"]
                             for n, c in prof["kernel_counts"].items() if "index" in n.lower()}
    h = torch.randn((G3_SLOTS, 1, cfg.d_model), generator=gen(31), device=DEV)
    table = params["embed"]["table"]
    nbytes = table.numel() * 4 + h.numel() * 4 + G3_SLOTS * cfg.vocab * 4
    b_ms, by = bound_ms(nbytes, 2.0 * G3_SLOTS * cfg.d_model * cfg.vocab, "f32")
    prof["readout"] = {"ms": event_ms(lambda: embedding_logits(params["embed"], h)),
                       "bound_ms": b_ms, "bound_by": by, "bytes": nbytes}
    del model, params, table
    torch.cuda.empty_cache()
    return prof


def run_gemma3_static() -> dict:
    """gemma3-4b through ``serve_static``: one batch of 4 x 1,536 prompt
    tokens (one prefill call at 6,144 rows, the local caches rolled), 16
    greedy tokens through the captured step; every launch counted."""
    from repro_torch.launch.serve import serve_static

    cfg = get_arch(GEMMA3)
    events = []
    kernels.reset_launches()
    report = serve_static(GEMMA3, policy="p8-serve", batch=G3_SLOTS, prompt_len=G3_PROMPT,
                          gen=G3_STATIC_GEN, seed=0, device="cuda", emit=events.append)
    torch.cuda.synchronize()
    assert report["mode"] == "static" and report["nonfinite_logit_rows"] == 0, report
    assert report["kv_nar_codes"] == 0, "NaR codes in the static gemma3 cache"
    assert_gemma3_launches(report["kernel_launches"],
                           gemma3_launches(cfg, G3_STATIC_GEN - 1, 1), "gemma3 static")
    return {k: report[k] for k in ("arch", "batch", "prompt_len", "gen", "decode_tok_per_s",
                                   "decode_steps", "compile_s", "prefill_s", "setup_s",
                                   "sample_tokens", "kv_cache_bytes", "cache_bytes_total",
                                   "kernel_launches")}


def gemma3_timings() -> list:
    """Phase 6's rows of gemma3-4b's decode shapes beside the bound and a
    PyTorch call: the GEMM at M = 4 on each linear shape (p8 B, the decode
    tile) against torch.matmul bf16 on the decoded weight; attention read
    cold at a global layer's S 1,600 and a local layer's full window
    (1,024), 4 rows of 8 q-heads over 4 KV heads, d 256, p8, against SDPA
    on the decoded f32 cache; each with its plain version's time."""
    cfg = get_arch(GEMMA3)
    rows = [dict(r, case=f"gemma3 gemm M4 {r['K']}x{r['N']} p8")
            for r in gemm_timings(4, G3_KN, plain=True)]
    for name, S in (("global", G3_PROMPT + G3_GEN), ("local", cfg.window)):
        q, k, v, lens = attn_inputs(8, B=G3_SLOTS, Hq=cfg.n_heads, Hkv=cfg.n_kv, d=cfg.hd, S=S,
                                    lengths=(S,) * G3_SLOTS, seed=40 + S)
        live = S * G3_SLOTS
        nbytes = 2 * live * cfg.n_kv * cfg.hd + 2 * q.numel() * 4 + lens.numel() * 4
        b_ms, by = bound_ms(nbytes, 4.0 * cfg.n_heads * cfg.hd * live, "f32")
        ms, n_rot = _cold_ms(lambda kc, vc: attn_ops.decode_attention(q, kc, vc, lens, 0,
                                                                      kv_bits=8), (k, v))
        kd, vd = (codec_ops.decode(t, 0, nbits=8) for t in (k, v))
        rows.append({"case": f"gemma3 {name} attention B4 8/4 d256 S{S} p8", "ms": ms,
                     "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "rotated_caches": n_rot,
                     "plain_ms": time_ms(lambda: posit_decode_attention_ref(q, k, v, lens, 0,
                                                                            kv_bits=8),
                                         windows=3, calls=2),
                     "library_ms": sdpa_ms(q, kd, vd, lens)})
        del q, k, v, kd, vd
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ the calibration path ----

CALIB_N, CALIB_BATCH, CALIB_SEQ = 4, 4, 64   # 4 batches of 4 x 64 tokens
CALIB_CHECK_SITES = ("attn/wq", "mlp/down", "lm_head")
CALIB_REQUESTS, CALIB_PROMPT, CALIB_GEN = 8, 64, 16
# the reduced olmoe's lm_loss on the card against the CPU under P8_SERVE:
# tests/test_torch_moe_loss.py's bounds against the reference (the final
# hidden state within 1e-2 of its largest magnitude, ce and aux 1e-4 relative)
MOE_LOSS_H, MOE_LOSS_REL = 1e-2, 1e-4


def fmt_counts(report: dict) -> dict:
    """Sites per chosen format, packed or not ("p8_1:packed": 6, ...)."""
    out: dict = {}
    for s in report["sites"]:
        key = s["fmt"] + (":packed" if s["packed"] else "")
        out[key] = out.get(key, 0) + 1
    return out


def site_weights(params, site: str) -> list:
    """Every float weight at ``site`` (one a layer), by the search's own rule."""
    from repro_torch.calib.search import _site_for
    from repro_torch.models.layers import _walk_linears

    return [parent[key] for path, parent, key in _walk_linears(params)
            if _site_for(path, [site]) == site]


def host_binade_hist(tensors) -> np.ndarray:
    """The binade histogram of ``tensors`` recounted on the host in float64
    numpy (``np.frexp``, exact), a thread a tensor: zeros, subnormals (the
    observer's rule) and nonfinite values in no bin."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.calib import observe

    def one(t):
        x = np.abs(t.detach().float().cpu().numpy().reshape(-1).astype(np.float64))
        x = x[np.isfinite(x) & (x >= np.finfo(np.float32).tiny)]
        s = np.clip(np.frexp(x)[1] - 1, observe.BIN_LO, observe.BIN_HI) - observe.BIN_LO
        return np.bincount(s, minlength=observe.NBINS).astype(np.float64)

    with ThreadPoolExecutor(8) as pool:
        return sum(pool.map(one, tensors))


def device_split(kern: dict) -> dict:
    """A call's device ms by what runs it (``time_ms``'s ``kernels_out``):
    the codec kernels (the straight-through encode and decode), the GEMM
    kernels (with their bf16 staging passes), and torch's own kernels
    (elementwise, reductions, norms, attention)."""
    out = {"codec": 0.0, "gemm": 0.0, "torch": 0.0}
    for name, (_, us) in kern.items():
        gemm = re.search(r"gemm|gemv|wgmma|large_fma|splitk|(a_bf16|b_bf16|mid_a16)_kernel", name)
        key = ("gemm" if gemm
               else "codec" if re.search(r"\b(encode|decode)_kernel", name) else "torch")
        out[key] += us / 1e3
    return out


def observed_forward_costs(model, params, batch, base) -> dict:
    """The device time of one loss unobserved and one observed (torch.profiler,
    ``time_ms``), split by ``device_split``, the observer's share of the
    observed one, and the launches by kernel key of one observed loss."""
    from repro_torch.calib.observe import Observer, observing

    def plain():
        with torch.no_grad():
            model.loss(params, batch, base)

    def observed():
        with observing(Observer()), torch.no_grad():
            model.loss(params, batch, base)

    k_plain, k_obs = {}, {}
    ms_plain = time_ms(plain, windows=1, calls=1, kernels_out=k_plain)
    ms_obs = time_ms(observed, windows=1, calls=1, kernels_out=k_obs)
    kernels.reset_launches()
    observed()
    torch.cuda.synchronize()
    split_plain, split_obs = device_split(k_plain), device_split(k_obs)
    return {"unobserved_ms": ms_plain, "observed_ms": ms_obs,
            "observer_share": (ms_obs - ms_plain) / ms_obs,
            "unobserved_split_ms": split_plain, "observed_split_ms": split_obs,
            "kernels_per_forward": {"unobserved": sum(r[0] for r in k_plain.values()),
                                    "observed": sum(r[0] for r in k_obs.values())},
            "observed_top_ms": {n: [r[0], r[1] / 1e3] for n, r in sorted(
                k_obs.items(), key=lambda kv: -kv[1][1])[:8]},
            "launches_one_observed_forward": {k: v for k, v in kernels.LAUNCHES.items() if v}}


def calibrate_full(arch, budgets, base=P8_SERVE) -> tuple:
    """``arch`` at full width and depth, float weights from seed 0, observed
    under ``base`` over CALIB_N batches of CALIB_BATCH x CALIB_SEQ tokens
    (and one more held out), searched at each budget; the launch counts set
    to 0 just before the observed run and read just after. Checks (a): the
    observed loss is the unobserved loss bit for bit. Returns (model,
    params, batches, observer, {budget: (policy, report)}, line)."""
    from repro_torch.calib import search
    from repro_torch.calib.observe import Observer, collect_stats, observing

    model = build_model(arch)
    t0 = time.perf_counter()
    params = model.init(0)
    batches = search.calibration_batches(arch, np.random.default_rng(0), CALIB_N + 1,
                                         batch=CALIB_BATCH, seq=CALIB_SEQ, device=model.device)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    loss = lambda b: model.loss(params, b, base)[0]          # noqa: E731
    with torch.no_grad():
        plain = loss(batches[0])
        with observing(Observer()):
            seen = loss(batches[0])
    assert torch.equal(plain.view(torch.int32), seen.view(torch.int32)), \
        f"{arch.name}: the observed loss {float(seen)} is not the unobserved {float(plain)}"
    kernels.reset_launches()
    t0 = time.perf_counter()
    obs = collect_stats(loss, batches[:CALIB_N])
    observe_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    plans = search.build_site_plans(params, obs)
    out = {}
    for budget in budgets:
        choice, report = search.search(plans, budget)
        report.update(n_sites=len(plans), name=f"calibrated-{arch.name}")
        out[budget] = (search.emit_policy(plans, choice, base=base, name=report["name"]),
                       report)
    search_s = time.perf_counter() - t0
    # calibrate_model, the entry point, chooses the same on the same run
    t0 = time.perf_counter()
    pol, report = search.calibrate_model(loss, batches[:CALIB_N], params, base=base,
                                         byte_budget=budgets[0],
                                         name=f"calibrated-{arch.name}")
    again_s = time.perf_counter() - t0
    assert pol.to_json() == out[budgets[0]][0].to_json(), \
        f"{arch.name}: calibrate_model chose otherwise on a second observed run"
    line = {"arch": arch.name, "base": base.describe(), "batches": [CALIB_N, CALIB_BATCH,
                                                                    CALIB_SEQ],
            "draw_s": draw_s, "observe_s": observe_s, "search_s": search_s,
            "calibrate_model_s": again_s, "observed_loss_bit_identical": True,
            "loss": float(plain), "launches": launches,
            "budgets": {b: {**{k: r[k] for k in ("n_sites", "p8_floor_bytes", "byte_budget",
                                                 "weight_bytes", "predicted_err_score")},
                            "formats": fmt_counts(r),
                            "sites": {x["path"]: x["fmt"] + (":packed" if x["packed"] else "")
                                      for x in r["sites"]}}
                        for b, (_, r) in out.items()}}
    return model, params, batches, obs, out, line


def check_calib_stats(params, obs, cfg) -> dict:
    """(b): at ``CALIB_CHECK_SITES`` the weight histogram is CALIB_N times a
    float64 numpy recount of the site's tensors on the host, and the act
    count is CALIB_N x 256 x d_in a layer at the site."""
    rows = {}
    for site in CALIB_CHECK_SITES:
        ws = site_weights(params, site)
        want = CALIB_N * host_binade_hist(ws)
        st = obs.get(site, "weight")
        assert np.array_equal(st.hist, want), f"{site}: the weight histogram is not the recount"
        assert st.n == CALIB_N * sum(w.numel() for w in ws)
        act = obs.get(site, "act")
        d_in = ws[0].shape[0]
        assert act.n == CALIB_N * CALIB_BATCH * CALIB_SEQ * d_in * len(ws), (site, act.n)
        rows[site] = {"layers": len(ws), "weight_n": st.n, "act_n": act.n,
                      "bins": int(np.count_nonzero(want))}
    return rows


def run_calib_phi3() -> dict:
    """phi3-mini-3.8b at full width: calibrated at 1x and 1.5x under the
    p8-serve base (checks (a)-(e)), the forward's costs, then the
    calibrated 1x policy and the p8-weights preset (the same bytes) served
    through the continuous engine and profiled (graph against eager)."""
    import os
    import tempfile

    from repro_torch.calib import search
    from repro_torch.core.pcsr import TransPolicy
    from repro_torch.core.policy import PRECISION_PRESETS, get_precision_policy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import quantize_params

    model, params, batches, obs, out, line = calibrate_full(PHI3, ("1x", "1.5x"))
    t0 = time.perf_counter()
    line["stats_checked"] = check_calib_stats(params, obs, PHI3)
    line["stats_check_s"] = time.perf_counter() - t0
    del obs
    t0 = time.perf_counter()
    line["forward"] = observed_forward_costs(model, params, batches[0], P8_SERVE)
    line["forward_costs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pol1, rep1 = out["1x"]
    pol15, rep15 = out["1.5x"]
    # (e) the 1.5x budget holds, and buys p16 somewhere
    assert rep15["weight_bytes"] <= rep15["byte_budget"], rep15["weight_bytes"]
    assert any(s["fmt"].startswith("p16") for s in rep15["sites"]), fmt_counts(rep15)
    # (c) the artifact reloads and quantizes to the same codes on the card
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        path = os.path.join(tmp, "cal.json")
        search.save_artifact(path, pol1, rep1)
        loaded = get_precision_policy("@" + path)
    q1 = quantize_params(params, pol1)
    for a, b in zip(tree_leaves(q1), tree_leaves(quantize_params(params, loaded))):
        assert a.dtype == b.dtype and torch.equal(a, b), "the reloaded artifact quantizes otherwise"
    # (d) the held-out batch: the calibrated policy's hidden state nearer the
    # float forward's than the p8-weights preset's at the same bytes
    preset = PRECISION_PRESETS["p8-weights"].with_base(P8_SERVE)
    with torch.no_grad():
        ref = model.forward(params, batches[-1], TransPolicy())
        errs = {}
        for name, pol in (("calibrated_1x", pol1), ("p8_weights", preset)):
            h = model.forward(params, batches[-1], pol)
            errs[name] = float(torch.sqrt(torch.mean((h - ref) ** 2) / torch.mean(ref ** 2)))
    assert errs["calibrated_1x"] < errs["p8_weights"], errs
    line["held_out_rel_rmse"] = errs
    qp = quantize_params(params, preset)
    del params, ref, h
    torch.cuda.empty_cache()
    line["checks_cde_s"] = time.perf_counter() - t0
    line["served"] = {}
    for name, pol, qparams, twin in (("calibrated_1x", pol1, q1, True),
                                     ("p8_weights", preset, qp, False)):
        t0 = time.perf_counter()
        line["served"][name] = calib_serve(model, qparams, pol, name, twin)
        line["served"][name]["seconds"] = time.perf_counter() - t0
    del q1, qp
    torch.cuda.empty_cache()
    return line


def calib_serve(model, params, pol, name: str, twin: bool) -> dict:
    """CALIB_REQUESTS requests (prompt CALIB_PROMPT, gen CALIB_GEN) through
    the continuous engine at 4 slots under ``pol`` (tokens/s over the run
    after a warm-up), then the captured step's device ms and idle share at
    4 busy slots, by ``profile_decode`` on the same params: with ``twin``
    graph against eager bit for bit, else the graph alone."""
    eng = ContinuousBatchingEngine(model, params, pol, max_slots=4,
                                   S_max=CALIB_PROMPT + CALIB_GEN, seed=0)
    eng.submit(Request(rid=-1, prompt=np.zeros((CALIB_PROMPT,), np.int32), max_new_tokens=3))
    eng.admit()
    eng.step()
    eng.reset(seed=0)
    reqs = poisson_requests(CALIB_REQUESTS, arrival_rate=0.0, prompt_lens=(CALIB_PROMPT,),
                            max_new_tokens=CALIB_GEN, vocab=model.cfg.vocab, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    makespan = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in done)
    assert len(done) == CALIB_REQUESTS and tokens == CALIB_REQUESTS * CALIB_GEN, (name, tokens)
    assert eng.nonfinite_rows == 0, f"{name}: non-finite logits"
    sample = min(done, key=lambda c: c.rid).tokens[:8]
    del eng
    torch.cuda.empty_cache()
    prof = profile_decode(model.cfg, pol, prompt_len=CALIB_PROMPT, model=model, params=params,
                          twin=twin)
    assert prof["captured"], f"{name}: the decode step was not captured"
    return {"tokens": tokens, "makespan_s": makespan, "decode_tok_per_s": tokens / makespan,
            "sample_tokens": sample, "graph_decode_tok_per_s": prof["decode_tok_per_s"],
            "step_wall_ms": prof["step_ms"],
            **({"graph_vs_eager": graph_line(name, prof)} if twin else {}),
            "step_device_ms": prof["device_busy_us_per_step"] / 1e3,
            "step_idle_share": prof["device_idle_share"],
            "launches_per_step": {k: v for k, v in prof["launches_per_step"].items() if v}}


def run_calib_olmoe() -> dict:
    """olmoe-1b-7b at full width: calibrated at 1x under the p8-serve base
    (check (a)); the expert sites among the sites; every expert product of
    the observed run on the mid-M kernel at C = 40 rows (three an expert, a
    layer and a batch, counted exactly); the forward's costs."""
    from repro_torch.models.moe import capacity

    olmoe = get_arch(OLMOE)
    model, params, batches, obs, out, line = calibrate_full(olmoe, ("1x",))
    sites = {s["path"] for s in out["1x"][1]["sites"]}
    assert {"moe/w_gate", "moe/w_up", "moe/w_down", "moe/router"} <= sites, sorted(sites)
    C = capacity(CALIB_BATCH * CALIB_SEQ, olmoe.top_k, olmoe.capacity_factor, olmoe.n_experts)
    experts = 3 * olmoe.n_experts * olmoe.n_layers
    assert line["launches"].get("posit_gemm_mid_tc") == CALIB_N * experts, line["launches"]
    del obs
    line["forward"] = observed_forward_costs(model, params, batches[0], P8_SERVE)
    line["expert_rows"] = C
    line["expert_gemm_launches_per_forward"] = experts
    line["sites"] = sorted(sites)
    del params, model
    torch.cuda.empty_cache()
    return line


def check_small_moe_loss(policy=P8_SERVE) -> dict:
    """The reduced olmoe-1b-7b's ``lm_loss`` (ce and aux) and final hidden
    state on the card against the same on the CPU (plain versions), within
    tests/test_torch_moe_loss.py's bounds."""
    cfg = get_arch(OLMOE).reduced()
    cpu_model, gpu_model = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params_cpu = cpu_model.init(0)
    params_gpu = _to(params_cpu, DEV)
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))}
    bg = {k: v.to(DEV) for k, v in b.items()}
    with torch.no_grad():
        _, mc = cpu_model.loss(params_cpu, b, policy)
        _, mg = gpu_model.loss(params_gpu, bg, policy)
        hc = cpu_model.forward(params_cpu, b, policy)
        hg = gpu_model.forward(params_gpu, bg, policy).cpu()
    h_err = float((hg - hc).abs().max() / hc.abs().max())
    rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k])) for k in ("ce", "aux")}
    assert h_err <= MOE_LOSS_H and max(rel.values()) <= MOE_LOSS_REL, (h_err, rel)
    return {"arch": cfg.name, "policy": policy.describe(), "hidden_err": h_err,
            "hidden_bound": MOE_LOSS_H, "loss_rel_err": rel, "loss_bound": MOE_LOSS_REL,
            "ce": float(mg["ce"]), "aux": float(mg["aux"])}


def check_measured_err() -> dict:
    """``errmodel.measured_sq_rel_err``, the error model's oracle, through
    the codec kernels on the card and through their plain versions on the
    CPU: the same value bit for bit for every candidate format at binades
    inside its range, at its edges and past them."""
    from repro_torch.calib.errmodel import CANDIDATES, expected_sq_rel_err, measured_sq_rel_err

    rows = {}
    for f in CANDIDATES:
        top = (f.nbits - 2) << f.es
        for s in sorted({-top - 1, -top, -3, 0, top - 1, top}):
            got, want = (measured_sq_rel_err(f.nbits, f.es, s, n_samples=4096, seed=s & 7,
                                             device=d) for d in ("cuda", "cpu"))
            assert got.hex() == want.hex(), (f.nbits, f.es, s, got, want)
            rows[f"p{f.nbits}_{f.es}@{s}"] = [got, expected_sq_rel_err(f.nbits, f.es, s)]
    return {"cases": len(rows), "bit_identical": True, "measured_vs_model": rows}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    seconds = build.build()
    log("build", seconds_each=seconds, seconds=time.perf_counter() - t0)

    codec_res = check_codec()
    log("codec", **codec_res)
    gemm_res = check_gemm()
    log("gemm", **gemm_res)
    log("gemm_batch_invariance", **check_gemm_batch_invariance())
    packed_res = check_packed_gemm()
    log("packed_gemm", **packed_res)
    p16_res = check_p16_gemm()
    log("p16_gemm", **p16_res)
    quire_res = check_quire_gemm()
    log("quire_gemm", **quire_res)
    log("quire_gemm_packed", **check_quire_packed())
    attn_res = check_attention()
    log("attention", **attn_res)
    paged_res = check_paged_attention()
    log("attention_paged", **paged_res)
    softmax_res = check_softmax()
    log("softmax", **softmax_res)
    t0 = time.perf_counter()
    alu_res = check_alu_fcvt()
    log("alu_fcvt", seconds=time.perf_counter() - t0, **alu_res)
    t0 = time.perf_counter()
    dataflow_res = check_dataflows()
    log("dataflows", seconds=time.perf_counter() - t0, **dataflow_res)
    from repro_torch.core.policy import get_precision_policy

    mixed_policy = get_precision_policy(MIXED, base=P8_SERVE)
    log("reduced_model", **check_small_model())
    for name in ("p8-packed", MIXED):
        log("reduced_model_" + name, **check_small_model(QWEN, get_precision_policy(name)))
    log("reduced_model_" + MIXED + "_p8_serve", **check_small_model(QWEN, mixed_policy))
    log("reduced_model_quire", **check_small_model(PHI3, parse_policy(QUIRE_SPEC), 2e-3))
    log("reduced_model_long_prefill", **check_small_model(prompt_len=300))
    olmoe = get_arch(OLMOE)
    log("reduced_model_olmoe", **check_small_model(olmoe))
    log("reduced_model_olmoe_" + MIXED, **check_small_model(olmoe, mixed_policy))
    log("reduced_model_granite", **check_small_model(get_arch(GRANITE)))
    log("reduced_model_whisper", **check_small_whisper())
    # gemma3 widened to 6 layers (layer 5 global), a 30-token prompt past the
    # window of 16, decode writes crossing the rolling buffers' end
    log("reduced_model_gemma3", **check_small_model(get_arch(GEMMA3), prompt_len=30, layers=6))

    keys = ("arch", "requests", "tokens", "decode_tok_per_s", "p50_token_ms", "p95_token_ms",
            "p50_ttft_ms", "decode_steps", "setup_s", "makespan_s", "kv_bytes_per_token",
            "kv_absmax")
    t0 = time.perf_counter()
    report, launches = run_main_path()
    log("main_path", seconds=time.perf_counter() - t0, launches=launches,
        **{k: report[k] for k in keys})
    DETAILS["serve_report"] = report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m_report, m_launches = run_mixed_path()
    log("mixed_path", seconds=time.perf_counter() - t0, launches=m_launches,
        **{k: m_report[k] for k in keys + ("weight_bytes_policy", "weight_bytes_f32")})
    DETAILS["mixed_serve_report"] = m_report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f_report, f_launches = run_mixed_fma_path()
    log("mixed_f32_path", seconds=time.perf_counter() - t0, launches=f_launches,
        **{k: f_report[k] for k in keys[:-1] + ("weight_bytes_policy", "weight_bytes_f32")})
    DETAILS["mixed_f32_serve_report"] = f_report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q_report, q_launches = run_quire_path()
    log("quire_path", seconds=time.perf_counter() - t0, launches=q_launches,
        **{k: q_report[k] for k in keys})
    DETAILS["quire_serve_report"] = q_report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l_report, l_launches = run_long_path()
    log("long_path", seconds=time.perf_counter() - t0, launches=l_launches,
        **{k: l_report[k] for k in keys})
    DETAILS["long_serve_report"] = l_report
    torch.cuda.empty_cache()
    sm_res, sm_launches = run_softmax_path()
    log("softmax_path", launches=sm_launches, **sm_res)
    t0 = time.perf_counter()
    p_report, p_launches = run_paged_path()
    log("paged_path", seconds=time.perf_counter() - t0, launches=p_launches, **p_report)
    DETAILS["paged_path_report"] = p_report
    t0 = time.perf_counter()
    ps_report, ps_launches = run_paged_serve()
    log("paged_serve", seconds=time.perf_counter() - t0, launches=ps_launches,
        **{k: ps_report[k] for k in keys + ("mode", "prefix_cache")})
    DETAILS["paged_serve_report"] = ps_report
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_report, moe_launches = run_moe_path()
    log("moe_path", seconds=time.perf_counter() - t0, launches=moe_launches,
        **{k: moe_report[k] for k in keys + ("weight_bytes_policy", "weight_bytes_f32")})
    DETAILS["moe_serve_report"] = moe_report
    # P8_SERVE swaps to f32 compute over its live rows in the recorded run
    prof = profile_decode(swap=dataclasses.replace(P8_SERVE, compute_dtype="f32"))
    log("profile", **profile_log(prof))
    assert prof["splitk_epilogue_calls_per_step"] == 0, \
        "the P8_SERVE decode step still launches a split-K epilogue kernel"
    assert_kv_write_fused(prof, QWEN, "P8_SERVE")
    DETAILS["decode_profile"] = prof
    l_prof = profile_decode(prompt_len=LONG_PROMPT)
    log("profile_long", **profile_log(l_prof))
    assert_kv_write_fused(l_prof, QWEN, "long-context")
    DETAILS["long_decode_profile"] = l_prof
    m_prof = profile_decode(QWEN, mixed_policy)
    log("profile_mixed", **profile_log(m_prof))
    # q/k/v/o of 48 layers at p16 on the tensor cores, no f32-FMA kernel and
    # no split-K epilogue; gate/up/down of 48 layers and lm_head on the packed
    # tensor-core variant
    assert m_prof["launches_per_step"]["posit_gemm_p16"] == 4 * QWEN.n_layers, m_prof
    assert m_prof["launches_per_step"]["posit_gemm"] == 0, m_prof
    assert m_prof["launches_per_step"]["posit_gemm_packed"] == 3 * QWEN.n_layers + 1, m_prof
    assert m_prof["gemm_kernels_per_step"].get("tc_gemm_kernel B kind 3") == \
        4 * QWEN.n_layers, m_prof["gemm_kernels_per_step"]
    assert "gemv_kernel B kind 3" not in m_prof["gemm_kernels_per_step"], \
        m_prof["gemm_kernels_per_step"]
    assert m_prof["splitk_epilogue_calls_per_step"] == 0, \
        "the mixed decode step still launches a split-K epilogue kernel"
    assert m_prof["gemm_kernels_per_step"].get("tc_gemm_kernel B kind 4") == \
        3 * QWEN.n_layers + 1, m_prof["gemm_kernels_per_step"]
    assert_kv_write_fused(m_prof, QWEN, "mixed")
    DETAILS["mixed_decode_profile"] = m_prof
    q_prof = profile_decode(PHI3, parse_policy(QUIRE_SPEC), prompt_len=32, share=True)
    log("profile_quire", **profile_log(q_prof))
    assert q_prof["quire_readout_kernels_per_step"] == 0, \
        "the quire decode step still launches a readout kernel"
    assert q_prof["quire_gemm_calls_per_step"] > 0 and \
        q_prof["quire_kernels_per_step"] == q_prof["quire_gemm_calls_per_step"], \
        "a quire GEMM call launched other than one kernel"
    # the quire linears encode their activations (one encode a call); the KV
    # write adds none
    assert_kv_write_fused(q_prof, PHI3, "quire", q_prof["quire_gemm_calls_per_step"])
    DETAILS["quire_decode_profile"] = q_prof
    from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine

    pg_prof = profile_decode(engine=PagedContinuousBatchingEngine,
                             engine_kw={"page_bytes": PAGED_PAGE_BYTES})
    log("profile_paged", **profile_log(pg_prof))
    # 48 paged attention launches a step, no dense attention and no encode
    assert_kv_write_fused(pg_prof, QWEN, "paged", attention="posit_attention_paged")
    DETAILS["paged_decode_profile"] = pg_prof
    # the paged path's 16 slots: where a step's time goes at M = 16
    pg16_prof = profile_decode(engine=PagedContinuousBatchingEngine,
                               engine_kw={"page_bytes": PAGED_PAGE_BYTES}, slots=PAGED_REQUESTS)
    log("profile_paged16", **profile_log(pg16_prof))
    # its linears (M = 16) on the mid-M kernel, 337 a step, no 64-row tile
    assert pg16_prof["launches_per_step"]["posit_gemm_mid_tc"] == 7 * QWEN.n_layers + 1, \
        pg16_prof["launches_per_step"]
    assert pg16_prof["launches_per_step"]["posit_gemm"] == 0, pg16_prof["launches_per_step"]
    assert pg16_prof["gemm_kernels_per_step"].get("mid_gemm_kernel B kind 2") == \
        7 * QWEN.n_layers + 1, pg16_prof["gemm_kernels_per_step"]
    assert_kv_write_fused(pg16_prof, QWEN, "paged, 16 slots", attention="posit_attention_paged")
    DETAILS["paged16_decode_profile"] = pg16_prof
    # olmoe built once for its profile and its paged run
    moe_model = build_model(olmoe)
    moe_params = moe_model.init(0, P8_SERVE)
    moe_prof = profile_decode(olmoe, model=moe_model, params=moe_params, keep_recorded=True)
    moe_recorded = moe_prof.pop("recorded")
    log("profile_moe", **profile_log(moe_prof))
    # one attention launch a layer and no encode; a layer's 4 + 1 + 3 x 64
    # linears and lm_head on the decode tiles
    per_step = moe_prof["launches_per_step"]
    assert per_step["posit_attention"] == olmoe.n_layers and per_step["posit_encode"] == 0, \
        per_step
    assert per_step["posit_gemm"] == moe_gemm_launches(olmoe, 1, 0)["posit_gemm"], per_step
    t0 = time.perf_counter()
    moe_paged = run_moe_paged(moe_model, moe_params, moe_recorded)
    log("moe_paged", seconds=time.perf_counter() - t0, **moe_paged)
    del moe_model, moe_params, moe_recorded
    torch.cuda.empty_cache()
    DETAILS["moe_decode_profile"] = moe_prof
    # the whisper path: static serving through the entry point, then graph
    # against eager and the captured step's profile on one set of params
    t_whisper = time.perf_counter()
    w_report, w_launches = run_whisper_path()
    log("whisper_path", seconds=time.perf_counter() - t_whisper, launches=w_launches,
        **{k: w_report[k] for k in ("arch", "batch", "prompt_len", "gen", "decode_tok_per_s",
                                    "decode_steps", "compile_s", "prefill_s", "setup_s",
                                    "sample_tokens", "kv_cache_bytes", "kv_absmax",
                                    "weight_bytes_policy", "weight_bytes_f32")})
    DETAILS["whisper_serve_report"] = w_report
    torch.cuda.empty_cache()
    w_model = build_model(get_arch(WHISPER))
    w_prof = whisper_graph_vs_eager(w_model, w_model.init(0, P8_SERVE))
    del w_model
    torch.cuda.empty_cache()
    log("whisper_profile", **w_prof)
    DETAILS["whisper_profile"] = w_prof
    log("whisper_phase", seconds=time.perf_counter() - t_whisper)
    # the gemma3 path: continuous serving through the entry point, graph
    # against eager on the same shape, then static mode
    card = nvidia_smi()
    t_g3 = time.perf_counter()
    g3_report, g3_launches = run_gemma3_path()
    log("gemma3_path", card=card, seconds=time.perf_counter() - t_g3, launches=g3_launches,
        **{k: g3_report[k] for k in keys + ("weight_bytes_policy", "weight_bytes_f32",
                                            "kv_cache_bytes")})
    DETAILS["gemma3_serve_report"] = g3_report
    torch.cuda.empty_cache()
    g3_prof = gemma3_graph_vs_eager()
    log("profile_gemma3", card=card, **profile_log(g3_prof))
    DETAILS["gemma3_decode_profile"] = g3_prof
    log("gemma3_static", card=card, **run_gemma3_static())
    torch.cuda.empty_cache()
    log("gemma3_phase", card=card, seconds=time.perf_counter() - t_g3)
    # every profiled path's decode step is one captured graph, bit for bit its
    # eager twin (asserted in profile_decode)
    for path, p in (("p8_serve", prof), ("long", l_prof), ("mixed", m_prof),
                    ("quire", q_prof), ("paged", pg_prof), ("paged16", pg16_prof),
                    ("moe", moe_prof)):
        log("graph_vs_eager", **graph_line(path, p))
        assert p["captured"], f"the {path} engine did not capture its decode step"
    log("graph_vs_eager", path="whisper", **{k: w_prof[k] for k in (
        "captured", "decode_steps_compared", "bit_identical", "launches_equal", "graph",
        "eager", "step_ms", "device_busy_ms_per_step", "device_idle_share")})
    # gemma3's step: device ms by the posit GEMM, attention, the tied
    # read-out (cuBLAS) and the glue, and the read-out timed alone
    log("graph_vs_eager", card=card, **graph_line("gemma3", g3_prof),
        device_ms_per_step=g3_prof["device_ms_per_step_by_group"], readout=g3_prof["readout"])
    # the calibration path after the served paths, their memory freed:
    # phi3-mini-3.8b (15.3 GB of f32 weights) then olmoe-1b-7b (27.6 GB)
    torch.cuda.empty_cache()
    t_calib = time.perf_counter()
    calib_phi3 = run_calib_phi3()
    DETAILS["calib_phi3"] = calib_phi3
    log("calib_path", card=card, **{k: v for k, v in calib_phi3.items() if k != "served"})
    for name, served in calib_phi3["served"].items():
        log("calib_serve", card=card, arch=PHI3.name, policy=name,
            **{k: v for k, v in served.items() if k != "graph_vs_eager"})
    log("graph_vs_eager", **calib_phi3["served"]["calibrated_1x"]["graph_vs_eager"])
    t0 = time.perf_counter()
    calib_olmoe = run_calib_olmoe()
    DETAILS["calib_olmoe"] = calib_olmoe
    log("calib_path", card=card, seconds=time.perf_counter() - t0, **calib_olmoe)
    log("calib_moe_loss", card=card, **check_small_moe_loss())
    log("calib_errmodel", card=card, **check_measured_err())
    log("calib_phase", card=card, seconds=time.perf_counter() - t_calib)
    torch.cuda.empty_cache()
    # phase 5t after the profiles: its 40 GB of allocations and its own
    # profiled steps come after every decode profile's window
    log("train_reduced", **check_train_reduced())
    log("linear_backward", **check_linear_backward())
    train_lines = {}
    for policy, steps, checks in (("p16-train", 6, True), ("none", 3, False)):
        t0 = time.perf_counter()
        train_lines[policy] = run_train_path(policy, steps, checks)
        log("train_path", seconds=time.perf_counter() - t0, **train_lines[policy])
        torch.cuda.empty_cache()
    DETAILS["train_paths"] = train_lines
    t0 = time.perf_counter()
    DETAILS["dataflow_timings"] = dataflow_timings()
    log("dataflow_timings", seconds=time.perf_counter() - t0, **DETAILS["dataflow_timings"])

    errs = {"posit_encode": codec_res["encode_max_abs_err"],
            "posit_decode": codec_res["decode_max_abs_err"],
            "posit_gemm": gemm_res["max_abs_err"], "posit_attention": attn_res["max_abs_err"],
            "posit_attention_paged": paged_res["max_abs_err"],
            "posit_gemm_packed": packed_res["max_abs_err"],
            "posit_gemm_packed_fma": packed_res["max_abs_err"],
            "posit_gemm_p16": p16_res["max_abs_err"],
            **gemm_res["large_m_max_abs_err"],
            "posit_quire_gemm": quire_res["max_abs_err"],
            "posit_softmax": softmax_res["max_abs_err"]}
    DETAILS["path_launches"] = {"p8_serve": launches, "mixed": m_launches,
                                "mixed_f32": f_launches, "quire": q_launches,
                                "long": l_launches, "softmax": sm_launches,
                                "paged": p_launches, "paged_serve": ps_launches,
                                "moe": moe_launches, "whisper": w_launches,
                                "gemma3": g3_launches,
                                "calib_phi3": calib_phi3["launches"],
                                "calib_olmoe": calib_olmoe["launches"],
                                **{"train_" + k: v["launches_run"]
                                   for k, v in train_lines.items()}}
    launches = dict(launches, posit_gemm_packed=m_launches["posit_gemm_packed"],
                    posit_gemm_p16=m_launches["posit_gemm_p16"],
                    posit_gemm_packed_fma=f_launches["posit_gemm_packed_fma"],
                    posit_quire_gemm=q_launches["posit_quire_gemm"],
                    posit_softmax=sm_launches["posit_softmax"],
                    posit_attention_paged=p_launches["posit_attention_paged"],
                    posit_gemm_large_tc=l_launches["posit_gemm_large_tc"],
                    posit_gemm_large_fma=train_lines["p16-train"]["launches_run"]
                    ["posit_gemm_large_fma"])
    rows = time_kernels(launches, errs)
    # the same kernels' rows with the gemma3 path's launch counts, and its
    # decode shapes timed
    log("gemma3_kernels", card=card, kernels=[dict(r, launches=g3_launches[r["name"]])
                                              for r in rows if g3_launches.get(r["name"])])
    DETAILS["gemma3_timings"] = gemma3_timings()
    log("gemma3_timings", card=card, rows=DETAILS["gemma3_timings"])
    DETAILS["whisper_timings"] = whisper_timings()
    log("whisper_timings", rows=DETAILS["whisper_timings"])
    DETAILS["train_timings"] = train_timings()
    log("train_timings", **DETAILS["train_timings"])
    log("attention_paged_timings", rows=DETAILS["paged_attention_timings"])
    log("gemm_large_timings", rows=DETAILS["gemm_large_timings"])
    smi = nvidia_smi()
    DETAILS.update(kernels=rows, nvidia_smi=smi, seconds=time.perf_counter() - t_start)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_details.json").write_text(json.dumps(DETAILS, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
