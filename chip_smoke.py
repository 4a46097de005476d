#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device,
nvcc and nvidia-smi. Phases, each of which raises on failure:

1. build the CUDA kernel of the path from ``src/repro_torch/csrc`` and
   print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (rtol 1e-4, atol 1e-4 * max|plain|: the
   sums run in another order), then time it (device time from
   torch.profiler, per-call time from CUDA events) beside its bound, its
   plain version and one PyTorch library call;
3. the main path: ``ServeEngine(monitor=True)`` serving tinyllama-1.1b at
   full width with random weights (8 prompts of 128 tokens, 32 new tokens,
   then one refill of a 64-token prompt), with every kernel launch count
   set to 0 just before and read just after; tokens must equal the
   unmonitored engine's, and sketches and logits must be finite; then
   prefill is timed on both engines, alternating, median of five;
4. the same engine on reduced tinyllama in f32 on the card and on the CPU,
   from the same weights and monitor state: equal tokens, and logits and
   sketches within rtol 1e-4, atol 1e-4;
5. print ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device or without the
repository's sources beside it. Measurements also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
TOL = 1e-4
PREFILL_SAMPLES = 5

# (label, T, d, k, A dtype): the serving path's shapes at tinyllama's
# d=2048 and k=9 (prefill T=B*S0=1024, decode T=B=8, refill T=S0=64),
# plus a ragged case and the paper's largest k=33
KERNEL_CASES = [
    ("prefill", 1024, 2048, 9, "bfloat16"),
    ("prefill", 1024, 2048, 9, "float32"),
    ("decode", 8, 2048, 9, "bfloat16"),
    ("decode", 8, 2048, 9, "float32"),
    ("refill", 64, 2048, 9, "bfloat16"),
    ("ragged", 37, 50, 9, "float32"),
    ("k33", 1024, 2048, 33, "bfloat16"),
]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warmup: int = 10) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, each a mean over
    ``iters`` calls after ``warmup``. Device ms sums the CUDA kernels that
    torch.profiler records; call ms comes from CUDA events around the
    loop, so it includes the host's enqueue time where that is longer
    (small shapes). Device ms is the call ms when the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        us += getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
    return (us / 1e3 / iters if us > 0 else call_ms), call_ms


def sketch_update_bound(T: int, d: int, k: int, a_bytes: int):
    """(bound_ms, bound_by): each input read once, each output written
    once. The three products (6*T*d*k flops) run at the bf16 tensor-core
    rate with each f32 operand split into a bf16 high and low part, which
    keeps the sums within the 1e-4 tolerance: two bf16 products per
    product for bf16 A, three for f32 A. The epilogue's 10*d*k flops run
    at the f32 rate."""
    nbytes = T * d * a_bytes + 3 * T * k * 4 + k * 4 + 6 * d * k * 4
    passes = 2 if a_bytes == 2 else 3
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = (passes * 6 * T * d * k / PEAK_BF16_FLOP_S
             + 10 * d * k / PEAK_F32_FLOP_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_kernels(dev) -> list[dict]:
    """Each kernel case against the plain version, then timed."""
    import torch
    from repro_torch.kernels.sketch_update import (
        sketch_update, sketch_update_ref,
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for label, T, d, k, a_dtype in KERNEL_CASES:
        dtype = getattr(torch, a_dtype)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        a = rand(T, d).to(dtype)
        x, y, z = rand(d, k), rand(d, k), rand(d, k)
        ups, omg, phi, psi = rand(T, k), rand(T, k), rand(T, k), rand(k)
        args = (a, x, y, z, ups, omg, phi, psi)
        got = sketch_update(*args, beta=0.9)
        want = sketch_update_ref(*args, 0.9)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale)
            err = max(err, float((g - w).abs().max()))
        pcat = torch.cat([ups, omg, phi], dim=1).to(dtype)
        ms, call_ms = time_ms(lambda: sketch_update(*args, beta=0.9), 200)
        plain_ms, plain_call_ms = time_ms(
            lambda: sketch_update_ref(*args, 0.9), 200)
        lib_ms, lib_call_ms = time_ms(lambda: torch.matmul(a.t(), pcat), 200)
        bound_ms, bound_by = sketch_update_bound(T, d, k, a.element_size())
        rows.append(dict(case=label, T=T, d=d, k=k, a_dtype=a_dtype,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, call_ms=call_ms,
                         plain_call_ms=plain_call_ms,
                         library_call_ms=lib_call_ms))
        log(f"sketch_update {label} T={T} d={d} k={k} {a_dtype}: "
            f"max_abs_err {err:.3e}  device us: kernel {ms * 1e3:.2f} "
            f"plain {plain_ms * 1e3:.2f} matmul {lib_ms * 1e3:.2f} "
            f"bound {bound_ms * 1e3:.3f} ({bound_by}); per call us: kernel "
            f"{call_ms * 1e3:.2f} plain {plain_call_ms * 1e3:.2f} matmul "
            f"{lib_call_ms * 1e3:.2f}")
    return rows


def _finite_tree(tree) -> bool:
    import torch
    node = tree.nodes["res"]
    return all(bool(torch.isfinite(t).all()) for t in (node.x, node.y, node.z))


def phase_serve(dev, cfg, batch: int, prompt_len: int, new_tokens: int,
                refill_len: int, max_context: int) -> dict:
    """The main path: monitored serving, counted, against monitor off."""
    import torch
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.telemetry import TelemetryLog, read_jsonl

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    refill_prompt = torch.randint(0, cfg.vocab_size, (refill_len,),
                                  generator=gen, device=dev)

    def engine(monitor, tlog=None):
        return ServeEngine(cfg=cfg, params=params, max_context=max_context,
                           monitor=monitor, device=dev, telemetry_log=tlog)

    # warm-up: library handles and the kernel's first load
    engine(True).generate(prompts, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    OUT_DIR.mkdir(exist_ok=True)
    tpath = OUT_DIR / "chip_smoke_serve.jsonl"
    with TelemetryLog(str(tpath)) as tlog:
        eng = engine(True, tlog)
        sketch_update.launches = sketch_update.kernel_launches = 0
        toks = eng.generate(prompts, new_tokens)
        t0 = time.perf_counter()
        eng.refill(1, refill_prompt)
        torch.cuda.synchronize()
        refill_ms = (time.perf_counter() - t0) * 1e3
        launches = {"sketch_update": sketch_update.launches}
        kernel_launches = sketch_update.kernel_launches
        tlog.append(eng.telemetry_record())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    want = cfg.num_layers * (1 + (new_tokens - 1) + 1)
    if launches["sketch_update"] != want:
        raise AssertionError(f"sketch_update launched "
                             f"{launches['sketch_update']} times on the main "
                             f"path, expected {want}")
    mon = eng._slots["mon"]
    if not _finite_tree(mon.tree):
        raise AssertionError("non-finite monitor sketches")
    if not bool(torch.isfinite(eng.last_logits.float()).all()):
        raise AssertionError("non-finite decode logits")
    if tuple(toks.shape) != (batch, new_tokens):
        raise AssertionError(f"tokens of shape {tuple(toks.shape)}")

    off = engine(False)
    toks_off = off.generate(prompts, new_tokens)
    off.refill(1, refill_prompt)
    if not torch.equal(toks, toks_off) or \
            not torch.equal(eng._slots["tok"], off._slots["tok"]):
        raise AssertionError("monitor on/off changed the generated tokens")

    _, recs = read_jsonl(str(tpath))
    if len(recs) != 2 or len(recs[-1].nodes) != cfg.num_layers:
        raise AssertionError("telemetry did not round-trip through JSONL")

    # prefill on the host's clock: one more warm-up of each engine, then
    # PREFILL_SAMPLES prefills each, alternating on and off; the median
    prefill = {True: [], False: []}
    for rep in range(PREFILL_SAMPLES + 1):
        for on, e in ((True, eng), (False, off)):
            torch.cuda.synchronize()
            before = e.spans["prefill"]
            e.start(prompts)
            if rep:
                prefill[on].append((e.spans["prefill"] - before) * 1e3)

    decode_steps = new_tokens - 1
    out = dict(
        arch=cfg.name, batch=batch, prompt_len=prompt_len,
        new_tokens=new_tokens, refill_len=refill_len,
        prefill_ms=statistics.median(prefill[True]),
        prefill_ms_monitor_off=statistics.median(prefill[False]),
        prefill_ms_samples=prefill[True],
        prefill_ms_samples_monitor_off=prefill[False],
        decode_tok_s=batch * decode_steps / eng.spans["decode"],
        decode_ms_per_step=eng.spans["decode"] * 1e3 / decode_steps,
        refill_ms=refill_ms, peak_mem_gib=peak_gib,
        decode_tok_s_monitor_off=batch * decode_steps / off.spans["decode"],
        launches=launches, kernel_launches=kernel_launches,
        flags=recs[-1].flags)
    log("serve: " + json.dumps(out))
    return out


def phase_device_vs_cpu(dev) -> dict:
    """Reduced tinyllama in f32 on the card and on the CPU, from the same
    weights, projections and monitor tree."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.sketches import (
        NodeSpec, gaussian_projections, init_node_tree,
    )

    cfg = reduced(get_arch("tinyllama-1.1b"))
    B, S0, k = 2, 8, 9
    gen = torch.Generator().manual_seed(2)
    params = init_params(gen, cfg)
    tree = init_node_tree(gen, {"res": NodeSpec(cfg.d_model, cfg.num_layers)},
                          num_tokens=B, k_max=k)
    proj = {n: gaussian_projections(gen, n, k) for n in (B * S0, S0)}
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen)
    refill_prompt = torch.randint(0, cfg.vocab_size, (S0,), generator=gen)

    def drive(device):
        eng = ServeEngine(cfg=cfg, params=params, max_context=32,
                          monitor=True, device=device, projections=proj,
                          initial_tree=tree)
        toks = [eng.start(prompts)]
        logits = []
        for _ in range(5):
            toks.append(eng.decode_step())
            logits.append(eng.last_logits)
        eng.refill(1, refill_prompt)
        toks.append(eng.decode_step())
        logits.append(eng.last_logits)
        node = eng._slots["mon"].tree.nodes["res"]
        return ([t.cpu() for t in toks], torch.stack(logits).cpu(),
                [t.cpu() for t in (node.x, node.y, node.z)])

    toks_d, logits_d, sk_d = drive(dev)
    toks_c, logits_c, sk_c = drive("cpu")
    if not all(torch.equal(a, b) for a, b in zip(toks_d, toks_c)):
        raise AssertionError("device and CPU tokens differ")
    torch.testing.assert_close(logits_d, logits_c, rtol=TOL, atol=TOL)
    err = float((logits_d - logits_c).abs().max())
    for a, b in zip(sk_d, sk_c):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
        err = max(err, float((a - b).abs().max()))
    log(f"device vs cpu: tokens equal, max abs diff {err:.3e}")
    return dict(max_abs_diff=err)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"chip_smoke: no src/repro_torch beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    log("nvcc sketch_update:\n" + _build.build("sketch_update"))
    build_s = time.perf_counter() - t0
    card = gpu_line()
    print(card, flush=True)
    log(f"built in {build_s:.1f}s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    kernel_rows = phase_kernels(dev)
    serve = phase_serve(dev, get_arch("tinyllama-1.1b"), batch=8,
                        prompt_len=128, new_tokens=32, refill_len=64,
                        max_context=256)
    dvc = phase_device_vs_cpu(dev)

    main_row = kernel_rows[0]           # prefill shape, bf16 A
    kernels = [dict(
        name="sketch_update", route="cuda",
        source="src/repro_torch/csrc/sketch_update.cu",
        replaces="src/repro/kernels/sketch_update.py:60",
        launches=serve["launches"]["sketch_update"],
        kernel_launches=serve["kernel_launches"],
        max_abs_err=max(r["max_abs_err"] for r in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"], by_shape=kernel_rows)]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, torch=torch.__version__,
        cuda=torch.version.cuda, kernels=kernels, serve=serve,
        device_vs_cpu=dvc), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
