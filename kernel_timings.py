"""Device times of the fused posit GEMM, the quire GEMM, the posit softmax and
decode attention on one NVIDIA GPU, for this checkout's package or for
another checkout's:

    python3 kernel_timings.py [--src DIR] [--profiles | --attention | --train | --prefill | --mid]

DIR is the ``src`` directory of another checkout, for example the parent
commit unpacked with ``git archive`` under ``build/`` (which .gitignore
lists). Run it in turns with this checkout's (parent, change, change,
parent) in one call on one card to compare two versions. It builds that
package's codec, GEMM, attention, quire GEMM and softmax kernels, then times, with
chip_smoke.py's phase-6 functions: the GEMM at every qwen2.5-14b decode
(M = 4, and M = 16 and 32: the 16-slot step and its neighbours) and prefill
(M = 64, no lm_head) shape beside its bound and torch.matmul bf16 on the
decoded weight; where the package has them, the
packed-p8 variants (tensor cores and f32 FMA) at the same shapes beside the
unpacked kernel and torch.matmul in their compute dtype, and p16 weights
at the attention projections' decode (M = 4) and prefill (M = 64) shapes,
(and M = 16)
under bf16 compute (the tensor cores; the f32-FMA kernels in packages
before them) and f32 compute (the f32-FMA kernels), beside torch.matmul
bf16 on the bf16-rounded decoded weight and f32 (TF32 off) and the kernel on
that bf16 weight (the same bytes, no decode); the quire GEMM at every
phi3-mini-3.8b decode (M = 4, lm_head 3072 x 32064 included) and prefill
(M = 32) shape beside its bound (bytes, or one int8 tensor-core MAC a
product) and a per-product loop's floor (4 int32 operations a product);
the softmax beside torch.softmax on the decoded rows; and decode attention
(``attention_timings``) at qwen2.5-14b's heads with p8 KV at S = 80, 512,
4,096 and 32,768, a ragged batch and p16 KV at 4,096, and phi3-mini-3.8b's
heads with p16 KV at 4,096, each read cold, beside its byte bound and
scaled_dot_product_attention on the decoded f32 cache; where the package has
the paged engine, the paged attention kernel read cold at S = 4,096 with
pages of 16 and of 1 token beside the dense kernel on the same codes
(``paged_attention_timings``).
With --profiles it also profiles one decode step of qwen2.5-14b under
P8_SERVE and under attn-p16-mlp-p8 over p8-serve, of phi3-mini-3.8b under
the quire, and, where the package has the paged engine, of qwen2.5-14b
under P8_SERVE on the paged engine at 16 slots (pages of 16 tokens; the
GEMM at M = 16) (chip_smoke.py ``profile_decode``: wall time, device time,
device kernels and the wrappers' launches a step), replayed from the
engine's captured CUDA graph and run eagerly (under "eager"), so a step's
before and after come from one card. A package whose engine captures no
graph runs both eagerly ("captured": false).
With --attention it builds only the codec and attention kernels and times
only decode attention (``attention_timings`` and, where the package has it,
``paged_attention_timings``), for a quick before and after of that kernel.
With --train (packages that have the training path) it builds only the
codec and GEMM kernels and times the training path's kernels at its shapes
(chip_smoke.py ``train_timings``: the GEMM with float B at M = 4,096 and
phi3-mini-3.8b's linear shapes under f32 and bf16 compute beside
torch.matmul, the codec at 32064 x 3072 p16_1) and its steps
(``run_train_path`` without its one-step checks: phi3-mini-3.8b at full
width, 16 layers, 8 x 512 tokens, p16-train for 6 steps and none for 3).
With --prefill it builds the codec, GEMM (the large-M kernels where the
package has them) and attention kernels and times the GEMM past the decode
shapes (chip_smoke.py ``large_gemm_timings``: qwen2.5-14b's prefill shapes at
M = 4,032 and 1,024 and the crossover sweep at M = 64 to 512, each route of
the package forced where it has two, beside torch.matmul), then the long
context path (4 x 4,032-token prompts, ``run_long_path``) and the paged path
(``run_paged_path``) for their TTFT.
With --mid it builds the codec, GEMM (the large- and mid-M kernels where
the package has them) and attention kernels and times the GEMM across the
row counts: p8 weights at every qwen2.5-14b shape at M = 4, 16, 32 and 64
(``gemm_timings``), the prefill shapes at M = 4,032, packed p8 under bf16
compute at M = 16 and 64, p16 at the attention projections at M = 16 and
64; then it profiles the paged engine's 16-slot P8_SERVE decode step
(device time, the GEMM's share, tokens/s), times one eager 64-token
prefill (wall against device time, ``prefill_ms``) and serves
chip_smoke.py's main path (8 x (64 + 16) tokens, P8_SERVE, 4 slots) for
its TTFT: the 64-token prefills' linears are M = 64 GEMMs.
It checks nothing (chip_smoke.py does) and prints one {"timings": ...} line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def prefill_ms(prompt_len: int = 64, reps: int = 5) -> dict:
    """A qwen2.5-14b P8_SERVE prefill of one ``prompt_len``-token prompt, eager,
    as the engine admits a request: the wall time (host clock around the
    call and a synchronize, median of ``reps`` after two warm-up calls)
    beside its device time (every kernel summed, chip_smoke.py ``time_ms``)
    and its GEMM launches."""
    import statistics
    import time

    import torch
    import chip_smoke as smoke
    from repro_torch import kernels
    from repro_torch.models.registry import build_model

    model = build_model(smoke.QWEN)
    params = model.init(0, smoke.P8_SERVE)
    toks = torch.randint(0, smoke.QWEN.vocab, (1, prompt_len), device=smoke.DEV,
                         generator=torch.Generator(device=smoke.DEV).manual_seed(3),
                         dtype=torch.int32)

    def call():
        return model.prefill(params, toks, smoke.P8_SERVE, S_max=prompt_len + 16)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    before = dict(kernels.LAUNCHES)
    call()
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    out = {"prompt_len": prompt_len, "wall_ms": statistics.median(walls), "wall_ms_runs": walls,
           "device_ms": smoke.time_ms(call, windows=3, calls=1), "launches": launches}
    del params, model
    return out


def main() -> int:
    src = (Path(sys.argv[sys.argv.index("--src") + 1]).resolve() if "--src" in sys.argv
           else ROOT / "src")
    sys.path.insert(0, str(src))
    # imported first, so that chip_smoke's own imports of the package resolve here
    import repro_torch
    import torch

    assert Path(repro_torch.__file__).resolve().is_relative_to(src), repro_torch.__file__
    if not torch.cuda.is_available():
        print("kernel_timings: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    paged = (src / "repro_torch" / "launch" / "paged_engine.py").exists()
    if "--attention" in sys.argv:
        res = {"src": str(src), "nvidia_smi": smi,
               "build_seconds": smoke.build.build(("posit_codec", "posit_attention")),
               "attention": smoke.attention_timings()}
        if paged:
            res["paged_attention"] = smoke.paged_attention_timings()
        print(json.dumps({"timings": res}))
        return 0
    gemm_libs = tuple(n for n in ("posit_gemm_large", "posit_gemm_mid")
                      if n in smoke.build.SOURCES)
    keep = ("step_ms", "decode_tok_per_s", "device_busy_us_per_step",
            "device_idle_share", "launches_per_step", "launches_all_kernels_per_step",
            "top", "captured", "graph_vs_eager", "gemm_kernels_per_step",
            "gemm_kernel_us_per_step")

    def paged16() -> dict:
        from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine

        prof = smoke.profile_decode(engine=PagedContinuousBatchingEngine,
                                    engine_kw={"page_bytes": smoke.PAGED_PAGE_BYTES},
                                    slots=smoke.PAGED_REQUESTS)
        out = {k: v for k, v in prof.items() if k in keep}
        out["eager"] = {k: v for k, v in prof["eager"].items() if k in keep}
        return out

    if "--mid" in sys.argv:
        res = {"src": str(src), "nvidia_smi": smi,
               "build_seconds": smoke.build.build(("posit_codec", "posit_gemm", *gemm_libs,
                                                   "posit_attention"))}
        for M in (4, 16, 32, 64):
            res[f"gemm_m{M}"] = smoke.gemm_timings(M, smoke.GEMM_KN if M < 64
                                                   else smoke.GEMM_KN[:-1])
        res["gemm_m4032"] = smoke.gemm_timings(smoke.LONG_PROMPT, smoke.GEMM_KN[:4])
        for M in (16, 64):
            res[f"packed_tc_m{M}"] = smoke.packed_timings(M, smoke.GEMM_KN[:4])
            res[f"p16_m{M}"] = smoke.p16_timings(M)
        torch.cuda.empty_cache()
        res["profile_paged16"] = paged16()
        torch.cuda.empty_cache()
        res["prefill64"] = prefill_ms()
        torch.cuda.empty_cache()
        report, launches = smoke.run_main_path()
        res["main_path"] = {k: report[k] for k in ("p50_ttft_ms", "p50_token_ms",
                                                   "decode_tok_per_s", "makespan_s")}
        res["main_path"]["launches"] = launches
        print(json.dumps({"timings": res}))
        return 0
    if "--prefill" in sys.argv:
        res = {"src": str(src), "nvidia_smi": smi,
               "build_seconds": smoke.build.build(("posit_codec", "posit_gemm", *gemm_libs,
                                                   "posit_attention")),
               "gemm_large": smoke.large_gemm_timings()}
        keys = ("p50_ttft_ms", "p95_ttft_ms", "ttft_ms", "decode_tok_per_s", "makespan_s",
                "launches")
        report, launches = smoke.run_long_path()
        res["long_path"] = {k: report[k] for k in keys if k in report}
        res["long_path"]["launches"] = launches
        torch.cuda.empty_cache()
        report, launches = smoke.run_paged_path()
        res["paged_path"] = {k: report[k] for k in ("grid4", "paged4", "grid16", "paged16")}
        res["paged_path"]["launches"] = launches
        print(json.dumps({"timings": res}))
        return 0
    if "--train" in sys.argv:
        res = {"src": str(src), "nvidia_smi": smi,
               "build_seconds": smoke.build.build(("posit_codec", "posit_gemm", *gemm_libs)),
               "train": smoke.train_timings()}
        for policy, steps in (("p16-train", 6), ("none", 3)):
            res[f"train_path_{policy}"] = smoke.run_train_path(policy, steps, checks=False)
            torch.cuda.empty_cache()
        print(json.dumps({"timings": res}))
        return 0
    seconds = smoke.build.build(("posit_codec", "posit_gemm", *gemm_libs, "posit_attention",
                                 "posit_quire_gemm", "posit_softmax"))
    res = {"src": str(src), "build_seconds": seconds,
           "gemm_decode": smoke.gemm_timings(4, smoke.GEMM_KN),
           "gemm_m16": smoke.gemm_timings(16, smoke.GEMM_KN),
           "gemm_m32": smoke.gemm_timings(32, smoke.GEMM_KN),
           "gemm_prefill": smoke.gemm_timings(64, smoke.GEMM_KN[:-1]),
           "gemm_p16_decode": smoke.p16_timings(),
           "gemm_p16_m16": smoke.p16_timings(16),
           "gemm_p16_prefill": smoke.p16_timings(64)}
    if (src / "repro_torch" / "core" / "pack.py").exists():   # packages with packed lanes
        for cd, name in ((torch.bfloat16, "packed_tc"), (torch.float32, "packed_fma")):
            res[f"{name}_decode"] = smoke.packed_timings(4, smoke.GEMM_KN, cd)
            res[f"{name}_prefill"] = smoke.packed_timings(64, smoke.GEMM_KN[:-1], cd)
        res["packed_tc_m16"] = smoke.packed_timings(16, smoke.GEMM_KN)
    res.update(
        quire_decode=smoke.quire_timings(4, smoke.PHI3_KN + (smoke.PHI3_LM_HEAD,)),
        quire_prefill=smoke.quire_timings(32, smoke.PHI3_KN),
        softmax=smoke.softmax_timings(),
        attention=smoke.attention_timings(),
        profiler_empty_windows=smoke.DETAILS.get("profiler_empty_windows", 0),
        nvidia_smi=smi)
    if paged:
        res["paged_attention"] = smoke.paged_attention_timings()
    if "--profiles" in sys.argv:
        from repro_torch.core.policy import get_precision_policy

        for name, args in (("p8_serve", (smoke.QWEN, smoke.P8_SERVE)),
                           ("mixed", (smoke.QWEN, get_precision_policy(
                               smoke.MIXED, base=smoke.P8_SERVE))),
                           ("quire", (smoke.PHI3, smoke.parse_policy(smoke.QUIRE_SPEC)))):
            prof = smoke.profile_decode(*args, prompt_len=64 if name != "quire" else 32)
            res[f"profile_{name}"] = {k: v for k, v in prof.items() if k in keep}
            res[f"profile_{name}"]["eager"] = {k: v for k, v in prof["eager"].items()
                                               if k in keep}
        if paged:
            res["profile_paged16"] = paged16()
    print(json.dumps({"timings": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
