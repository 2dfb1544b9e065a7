#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it, in phases.

  1. build    compile the CUDA kernels from src/repro_torch/csrc (nvcc,
              sm_90a) and print the seconds taken;
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version at the serving path's shapes, in bf16 and f32, and
              time the kernel, the plain version, one PyTorch library call
              of the same function, and the card's bound for the work;
  3. small    a smoke-size model on the card (kernels) against the same
              model on the CPU (plain versions): prefill and decode logits
              and greedy tokens;
  4. serve    ServingEngine with the full qwen2-moe-a2.7b config (24
              layers, bf16 weights drawn from a seed on the card): 16
              requests, 8 slots, max_context 1024; every kernel must have
              launched during serving;
  5. report   one JSON line with every kernel's numbers, the card's name and
              power limit, and as the last line {"ok": true, "device": ...}.

Any failure ends the run with a traceback and a non-zero exit. Without a
CUDA device it exits non-zero and prints no result.

Run from the repository root:  python3 chip_smoke.py
(``--no-serve`` stops after phase 3: a quick check of new kernels.)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import kernels as kernel_lib  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import moe_gemm  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.runtime import Request, RequestState, ServingEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32: summation order differs; bf16: the reference's kernel tolerance
# (tests/test_kernels.py:19-20)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max())
    ok = torch.allclose(g, w, **TOL[dtype])
    print(f"  {name}: max_abs_err={err:.3e} "
          f"(rtol={TOL[dtype]['rtol']}, atol={TOL[dtype]['atol']}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def randn(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    info = build.last_build
    print(f"[build] {'compiled' if info.get('compiled') else 'cached'} "
          f"{len(build.sources())} sources into {build.library_path().name}"
          f" in {dt:.1f} s")
    for line in str(info.get("report", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_decode(gen):
    print("[kernels] decode_attention")
    B, H, Kv, D, C = 8, 16, 16, 128, 1024
    lengths = torch.tensor([0, 1, C, 37, 500, 1000, 33, 613],
                           dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, H, D), dtype)
        k = randn(gen, (B, C, Kv, D), dtype)
        v = randn(gen, (B, C, Kv, D), dtype)
        out = decode_attention(q, k, v, lengths)
        zero_rows = out[lengths == 0].float().abs().max()
        if float(zero_rows) != 0.0:
            fail("decode_attention: a length-0 row is not exactly zero")
        errs[dtype] = compare(f"B={B} H={H} Kv={Kv} D={D} C={C} {dtype}",
                              out, decode_attention_ref(q, k, v, lengths),
                              dtype)
    # GQA (qwen2-1.5b heads) and a cache length that is not a tile multiple
    lg = torch.tensor([600, 0, 17, 333], dtype=torch.int32, device="cuda")
    q = randn(gen, (4, 12, 128), torch.float32)
    k = randn(gen, (4, 600, 2, 128), torch.float32)
    v = randn(gen, (4, 600, 2, 128), torch.float32)
    compare("GQA g=6 C=600 f32", decode_attention(q, k, v, lg),
            decode_attention_ref(q, k, v, lg), torch.float32)

    dtype = torch.bfloat16
    q = randn(gen, (B, H, D), dtype)
    k = randn(gen, (B, C, Kv, D), dtype)
    v = randn(gen, (B, C, Kv, D), dtype)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(C, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    ms = time_ms(lambda: decode_attention(q, k, v, lengths))
    plain = time_ms(lambda: decode_attention_ref(q, k, v, lengths))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask))
    tokens = int(lengths.clamp(0, C).sum())
    es = 2
    nbytes = (2 * B * H * D + 2 * tokens * Kv * D) * es + 4 * B
    flops = 4.0 * tokens * H * D
    b, by = bound_ms(nbytes, flops, dtype)
    return dict(name="decode_attention", source=dec_kernel.SOURCE,
                replaces=dec_kernel.REPLACES, max_abs_err=errs[dtype],
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib,
                shape=f"B={B} H={H} Kv={Kv} D={D} C={C} lengths="
                      f"{lengths.tolist()} bf16")


def check_moe_gemm(gen):
    print("[kernels] moe_gemm")
    E, M, H = 60, 2048, 1408
    errs = {}
    timing = None
    for C in (1, 683):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (E, C, M), dtype)
            wg = randn(gen, (E, M, H), dtype, M ** -0.5)
            wu = randn(gen, (E, M, H), dtype, M ** -0.5)
            wd = randn(gen, (E, H, M), dtype, H ** -0.5)
            err = compare(f"E={E} C={C} M={M} H={H} {dtype}",
                          moe_gemm(x, wg, wu, wd),
                          moe_gemm_ref(x, wg, wu, wd), dtype)
            errs[(C, dtype)] = err
            if dtype == torch.bfloat16:
                ms = time_ms(lambda: moe_gemm(x, wg, wu, wd))
                plain = time_ms(lambda: moe_gemm_ref(x, wg, wu, wd), iters=5)
                lib = time_ms(lambda: torch.bmm(
                    F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd))
                flops = 6.0 * E * C * M * H
                nbytes = (2 * E * C * M + 3 * E * M * H) * 2
                b, by = bound_ms(nbytes, flops, dtype)
                print(f"  C={C} bf16: kernel {ms:.3f} ms, plain {plain:.3f} "
                      f"ms, torch.bmm x3 {lib:.3f} ms, bound {b:.3f} ms "
                      f"({by})")
                if C == 683:
                    timing = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bound_ms=b, bound_by=by)
            del x, wg, wu, wd
            torch.cuda.empty_cache()
    return dict(name="moe_gemm", source=gemm_kernel.SOURCE,
                replaces=gemm_kernel.REPLACES,
                max_abs_err=errs[(683, torch.bfloat16)], **timing,
                shape=f"E={E} C=683 M={M} H={H} bf16")


def check_flash(gen):
    print("[kernels] flash_attention")
    H, Kv, D = 16, 16, 128
    errs = {}
    timing = None
    for B, S in ((8, 64), (2, 1024), (2, 600)):
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, S, H, D), dtype)
            k = randn(gen, (B, S, Kv, D), dtype)
            v = randn(gen, (B, S, Kv, D), dtype)
            errs[(S, dtype)] = compare(
                f"B={B} S={S} H={H} Kv={Kv} D={D} {dtype}",
                flash_attention(q, k, v), flash_attention_ref(q, k, v),
                dtype)
            if S == 1024 and dtype == torch.bfloat16:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                ms = time_ms(lambda: flash_attention(q, k, v))
                plain = time_ms(lambda: flash_attention_ref(q, k, v))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
                flops = 4.0 * B * H * D * S * (S + 1) / 2
                nbytes = (2 * B * S * H * D + 2 * B * S * Kv * D) * 2
                b, by = bound_ms(nbytes, flops, dtype)
                timing = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b, bound_by=by)
    # GQA with a sliding window (the kernel's window bound), ragged S
    q = randn(gen, (1, 600, 12, 128), torch.float32)
    k = randn(gen, (1, 600, 2, 128), torch.float32)
    v = randn(gen, (1, 600, 2, 128), torch.float32)
    compare("GQA g=6 S=600 window=128 f32",
            flash_attention(q, k, v, window=128),
            flash_attention_ref(q, k, v, window=128), torch.float32)
    return dict(name="flash_attention", source=flash_kernel.SOURCE,
                replaces=flash_kernel.REPLACES,
                max_abs_err=errs[(1024, torch.bfloat16)], **timing,
                shape=f"B=2 S=1024 H={H} Kv={Kv} D={D} causal bf16")


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def phase_small() -> None:
    for arch in ("qwen2-moe-a2.7b", "qwen2-1.5b"):
        cfg = get_smoke_config(arch)
        ctx = ExecutionContext(attn_impl="decode_kernel")
        cpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cpu")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        p_cpu = cpu.init(gen)
        gpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cuda")
        p_gpu = params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32)
        rng = np.random.RandomState(0)
        lens = [5, 9, 13]
        toks = np.zeros((3, 16), np.int64)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
        last = torch.tensor([n - 1 for n in lens])
        worst = 0.0
        outs = {}
        for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
            logits, caches = model.prefill(params, torch.from_numpy(toks),
                                           seq_budget=32,
                                           last_positions=last)
            for c in caches:
                c["index"] = torch.tensor(lens, dtype=torch.int32,
                                          device=model.device)
            seq = [logits[:, -1].float().cpu()]
            lengths = torch.tensor(lens, dtype=torch.int32) + 1
            for _ in range(4):
                nxt = seq[-1].argmax(-1)[:, None]
                logits, caches = model.decode_step(params, nxt, caches,
                                                   lengths=lengths)
                seq.append(logits[:, -1].float().cpu())
                lengths = lengths + 1
            outs[name] = seq
        for a, b in zip(outs["cpu"], outs["gpu"]):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                fail(f"{arch} smoke: card logits disagree with the CPU")
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"{arch} smoke: greedy tokens disagree with the CPU")
        print(f"[small] {cfg.name}: prefill + 4 decode steps on the card "
              f"match the CPU (max |dlogit| {worst:.2e}, rtol=atol=1e-4), "
              "greedy tokens equal")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


# ---------------------------------------------------------------------------
# phase 4: serve the full-width model
# ---------------------------------------------------------------------------

def phase_serve():
    cfg = get_config("qwen2-moe-a2.7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.2f} B params in bf16 drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 601))
        reqs.append(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                    size=n)),
                            max_new_tokens=32,
                            temperature=0.0 if i % 2 == 0 else 0.8))
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_lib.launch_counts()

    if len(finished) != len(reqs):
        fail(f"served {len(finished)}/{len(reqs)} requests")
    for r in reqs:
        if r.state != RequestState.FINISHED or len(r.output) != 32:
            fail(f"request {r.request_id}: {r.state} with "
                 f"{len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"request {r.request_id}: token out of the vocabulary")
    st = eng.stats
    L = cfg.num_layers
    expect = {"decode_attention": L * st.steps,
              "flash_attention": L * st.prefill_calls,
              "moe_gemm": L * (st.steps + st.prefill_calls)}
    for name, n in counts.items():
        if n <= 0:
            fail(f"{name} never launched during serving")
        if n != expect[name]:
            fail(f"{name}: {n} launches, expected {expect[name]}")
    tokens = sum(len(r.output) for r in reqs)
    ttft = np.array([r.ttft for r in reqs]) * 1e3
    res = dict(requests=len(finished), tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_mean_ms=float(ttft.mean()),
               ttft_p90_ms=float(np.percentile(ttft, 90)),
               decode_steps=st.steps,
               decode_step_ms=st.decode_s / st.steps * 1e3,
               prefill_calls=st.prefill_calls,
               prefill_ms_mean=st.prefill_s / st.prefill_calls * 1e3,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=counts,
               launches_per_decode_step={
                   k: counts[k] / st.steps
                   for k in ("decode_attention",)})
    print(f"[serve] {tokens} tokens for {len(finished)} requests in "
          f"{wall:.2f} s -> {res['tokens_per_s']:.1f} tokens/s; TTFT mean "
          f"{res['ttft_mean_ms']:.0f} ms, p90 {res['ttft_p90_ms']:.0f} ms; "
          f"{st.steps} decode steps at {res['decode_step_ms']:.2f} ms; "
          f"{st.prefill_calls} prefill calls at "
          f"{res['prefill_ms_mean']:.1f} ms; peak memory "
          f"{res['peak_mem_gb']:.2f} GB")
    print(f"[serve] launches during serving: {counts} "
          f"(decode_attention {L} per decode step)")
    print("[serve] " + json.dumps(res))
    profile_decode(eng, rng, cfg)
    del eng
    torch.cuda.empty_cache()
    return counts


def profile_decode(eng, rng, cfg, steps: int = 3) -> None:
    """Where a steady decode step's time goes: the wall time of ``steps``
    plain decode steps, then the same number under torch.profiler for the
    device time by kernel; the idle share is 1 - kernel time / plain wall
    time (one stream, so kernels do not overlap)."""
    for _ in range(eng.num_slots):
        eng.submit(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                   size=300)),
                           max_new_tokens=2 * steps + 2))
    eng.step()                      # admit + prefill + first decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_kernel.values()) / 1e3 / steps
    print(f"[profile] decode step, 8 slots at ~300-token contexts: wall "
          f"{wall_ms:.2f} ms/step, kernels {busy_ms:.2f} ms/step "
          f"({sum(n for _, n in per_kernel.values()) // steps} launches), "
          f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for name, (us, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step {n // steps:5d}/step  "
              f"{name[:80]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-serve", action="store_true",
                    help="stop after the kernel and small-model phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entries = [check_decode(gen), check_moe_gemm(gen), check_flash(gen)]
    torch.cuda.empty_cache()
    phase_small()
    counts = {e["name"]: 0 for e in entries}
    if not args.no_serve:
        counts = phase_serve()

    report = []
    for e in entries:
        e = dict(e, route="cuda", launches=counts[e["name"]], ok=True)
        report.append(e)
        print(f"[report] {e['name']}: {e['ms']:.3f} ms (plain "
              f"{e['plain_ms']:.3f}, library {e['library_ms']:.3f}, bound "
              f"{e['bound_ms']:.4f} by {e['bound_by']}) at {e['shape']}; "
              f"{e['launches']} launches while serving")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"kernels": report}))
    print(smi)
    if args.no_serve:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
