#!/usr/bin/env python3
"""Drive the PyTorch port (``sparkflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Imports no JAX.
Phases — any failure exits nonzero with its traceback and prints no result:

1. set-up: the card's name and power limit; build the CUDA kernels from
   ``sparkflow_tpu_torch/ops/csrc`` and print ptxas's registers, shared
   memory and spills;
2. kernels against their plain PyTorch versions at the serving path's
   shapes, in bfloat16 and float32, and their times beside the plain
   version's, the least time the card could take (``bound_ms``) and, for
   flash, ``F.scaled_dot_product_attention`` as a yardstick only. ``ms``,
   ``plain_ms`` and ``library_ms`` are device times (CUDA-graph replays
   between CUDA events); ``call_ms`` in the detail line is the time per
   call as the host enqueues it one at a time;
3. serving: a GPT-2-small-width ``transformer_lm`` (random weights from a
   seed, bf16 compute) behind ``DecodeEngine`` -> ``ContinuousBatcher`` ->
   ``InferenceServer``, eight concurrent ``ServingClient.generate`` calls;
   the kernels' launch counters are zeroed just before and read just after;
4. profile: ``torch.profiler`` over 20 decode steps with 8 live slots and
   over one 700-token prefill — device busy time, idle share, top kernels;
5. exactness: float32 with TF32 off, all 12 layers — the engine's greedy
   tokens equal the argmax of the dense full-sequence forward over the plain
   attention, and prefill logits agree within 1e-3.

The line before the last gives the card's name and power limit; the last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``. Exits nonzero, printing no result, where there is no CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PAGED_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}

GPT2_SMALL = dict(vocab_size=50257, hidden=768, num_layers=12, num_heads=12,
                  mlp_dim=3072, max_len=1024, dropout=0.0)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_device(fns, replays: int = 7) -> float:
    """The card's milliseconds per call: ``fns`` are called once each to
    warm up, captured in order into one CUDA graph, and the graph is
    replayed between CUDA events. Nothing is enqueued by the host inside
    the timed interval, so launch overhead is out; the median replay over
    ``len(fns)``."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = _events()
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return sorted(times)[len(times) // 2] / len(fns)


def time_calls(fn, reps: int = 20) -> float:
    """Milliseconds per call as the serving path pays it, one call at a
    time: CUDA events around each call, so the host's time to enqueue it
    (the wrapper's Python, the ctypes call) counts where it exceeds the
    card's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _bound(nbytes: float, flops: float, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def phase_setup():
    from sparkflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[setup] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, lines in _build.ptxas_report().items():
        log(f"[setup] ptxas {src}:")
        for ln in lines:
            # a mangled entry name, e.g. 16flash_fwd_kernelI13__nv_bfloat16Li2EE
            entry = re.search(r"entry function '\w*?\d([a-z_]+_kernel)I(\w+?)EE",
                              ln)
            if entry:
                log(f"  {entry.group(1)}<{entry.group(2)}>")
            elif "registers" in ln or "spill" in ln:
                log("   ", ln.split(":", 1)[-1].strip())


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels(card):
    import torch
    import torch.nn.functional as F
    import numpy as np
    from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                         paged_attention,
                                         paged_attention_reference)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    flash_err, paged_err = 0.0, 0.0
    flash_rows, paged_rows = [], []

    # -- flash attention: the prefill buckets of the serving phase ----------
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        for s in (16, 100, 128, 1024):
            g = torch.Generator(device=dev).manual_seed(s)
            q, k, v = (torch.randn(1, 12, s, 64, generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
            ref, ref_lse = attention_reference(q, k, v, causal=True,
                                               return_lse=True)
            torch.cuda.synchronize()
            e, el = max_err(out, ref), max_err(lse, ref_lse)
            if not (e < FLASH_TOL[dn] and el < LSE_TOL[dn]):
                raise AssertionError(f"flash_fwd {dn} S={s}: max |dO| {e} "
                                     f"(tol {FLASH_TOL[dn]}), max |dlse| "
                                     f"{el} (tol {LSE_TOL[dn]})")
            flash_err = max(flash_err, e)
            # q, k, v read once, O written once; causal QK^T and PV over the
            # S(S+1)/2 (query, key) pairs at or below the diagonal
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4 * 64 * 12 * s * (s + 1) / 2
            kern = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
            row = {"dtype": dn, "S": s, "max_abs_err": e, "lse_err": el,
                   "ms": time_device([kern] * 20),
                   "call_ms": time_calls(kern),
                   "plain_ms": time_device([lambda: attention_reference(
                       q, k, v, causal=True)] * 5),
                   "library_ms": time_device([lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True)] * 20),
                   "bytes": nbytes, "flops": flops}
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
            flash_rows.append(row)
            log(f"[kernels] flash_fwd {dn} B=1 H=12 S={s} D=64 causal: "
                f"err {e:.3g} lse_err {el:.3g} ms {row['ms']:.5f} (per "
                f"call {row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                f"sdpa {row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
                f"({row['bound_by']}) [{card}]")
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn(2, 12, 256, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        mask = torch.ones(2, 256, device=dev)
        mask[0, 200:] = 0
        mask[1, 77:] = 0
        e = max_err(flash_attention(q, k, v, kv_mask=mask),
                    attention_reference(q, k, v, kv_mask=mask))
        if not e < FLASH_TOL[dn]:
            raise AssertionError(f"flash_fwd {dn} masked: max |dO| {e}")
        flash_err = max(flash_err, e)
        log(f"[kernels] flash_fwd {dn} B=2 S=256 non-causal ragged mask: "
            f"err {e:.3g}")

    # -- paged attention: the decode step's shapes --------------------------
    b, h, d, page, maxp, num_pages = 8, 12, 64, 16, 64, 513
    lengths = torch.tensor([0, 1, 17, 100, 255, 512, 700, 1024],
                           dtype=torch.int32, device=dev)
    rs = np.random.RandomState(0)
    table = rs.permutation(np.arange(1, num_pages))[:b * maxp].reshape(b, maxp)
    table[3, :2] = table[2, :2]                   # aliased shared prefix
    table[0] = 0                                  # empty slot -> scratch page
    # the pool rows this run's lengths need, each counted once (the aliased
    # pages of slots 2 and 3 are one set of rows)
    rows = {(int(table[i, t // page]), t % page)
            for i, n in enumerate(lengths.tolist()) for t in range(n)}
    table = torch.as_tensor(table, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        kp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        vp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        out = paged_attention(q, kp, vp, table, lengths)
        ref = paged_attention_reference(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        if not e < PAGED_TOL[dn] or not bool(torch.all(out[0] == 0)):
            raise AssertionError(f"paged_attention {dn}: max |d| {e} (tol "
                                 f"{PAGED_TOL[dn]}); empty slot zero: "
                                 f"{bool(torch.all(out[0] == 0))}")
        paged_err = max(paged_err, e)
        itemsize = q.element_size()
        toks = int(lengths.sum())
        # K and V rows read once, q read and O written, table and lengths
        nbytes = (2 * len(rows) * h * d * itemsize + 2 * q.numel() * itemsize
                  + table.numel() * 4 + lengths.numel() * 4)
        flops = 4 * h * d * toks
        # in a decode step the layer's pool comes cold from device memory
        # (between two layers' calls the step streams a layer's weights,
        # 7M parameters read as float32 and cast to bf16): time launches
        # over 12 copies of the pool, ~90 MB of live rows between two visits
        # of one copy, more than the 50 MB L2
        pools = [(kp.clone(), vp.clone()) for _ in range(12)]
        kern = [lambda kk=kk, vv=vv: paged_attention(q, kk, vv, table, lengths)
                for kk, vv in pools]
        plain = [lambda kk=kk, vv=vv: paged_attention_reference(
            q, kk, vv, table, lengths) for kk, vv in pools]
        row = {"dtype": dn, "tokens": toks, "max_abs_err": e,
               "ms": time_device(kern),
               "call_ms": time_calls(lambda: paged_attention(
                   q, kp, vp, table, lengths)),
               "plain_ms": time_device(plain),
               "library_ms": None, "bytes": nbytes, "flops": flops}
        del pools, kern, plain
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
        paged_rows.append(row)
        log(f"[kernels] paged_attention {dn} B=8 H=12 D=64 page=16 "
            f"live tokens {toks}: err {e:.3g} ms {row['ms']:.5f} (per call "
            f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} bound "
            f"{row['bound_ms']:.5f} ({row['bound_by']}) [{card}]")
    log("[kernels] detail " + json.dumps({"flash_fwd": flash_rows,
                                          "paged_attention": paged_rows}))
    # the kernels line reports the serving phase's own shapes: bf16, the
    # largest prefill bucket for flash, the decode step for paged
    main_flash = next(r for r in flash_rows
                      if r["dtype"] == "bfloat16" and r["S"] == 1024)
    main_paged = next(r for r in paged_rows if r["dtype"] == "bfloat16")
    return ({"max_abs_err": flash_err, **_pick(main_flash)},
            {"max_abs_err": paged_err, **_pick(main_paged)})


def _pick(row):
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def _device_profile(prof, wall_ms: float, per: int) -> dict:
    """The card's share of a profiled window: the union of its kernel, copy
    and memset intervals (GPU-side ``record_function`` ranges excluded)
    against the window's host wall time, and the kernels that took most of
    it, all per ``per`` (steps or prefills)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not evs:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, end = 0.0, -math.inf
    by_name = {}
    for e in sorted(evs, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (t - s))
    busy_ms = busy / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms / per, "device_busy_ms": busy_ms / per,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": len(evs) / per,
            "top": [{"name": n[:90], "calls": c / per, "ms": us / 1e3 / per}
                    for n, (c, us) in top]}


def phase_profile(card, eng):
    """Where the serving path's time goes, under ``torch.profiler``: a
    steady window of decode steps with all 8 slots live, and one prefill of
    a 700-token prompt (the 1024 bucket)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    vocab = GPT2_SMALL["vocab_size"]
    slots = [eng.prefill(rng.integers(0, vocab, n).tolist(),
                         max_new_tokens=200)["slot"]
             for n in (17, 64, 100, 128, 255, 300, 512, 700)]
    steps = 20
    for _ in range(5):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    decode = {"steps": steps, "step_ms_unprofiled": plain_ms,
              **_device_profile(prof, wall, steps)}
    for s in slots:
        eng.release(s)
    eng.kv.flush_prefix_index()
    prompt = rng.integers(0, vocab, 700).tolist()
    eng.release(eng.prefill(prompt, max_new_tokens=1)["slot"])   # warm
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = eng.prefill(rng.integers(0, vocab, 700).tolist(),
                           max_new_tokens=1)["slot"]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    eng.release(slot)
    prefill = {"prompt": 700, "bucket": 1024, **_device_profile(prof, wall, 1)}
    log("[profile] " + json.dumps({"decode_step_8_slots": decode,
                                   "prefill_700": prefill, "card": card}))


def _lm(compute_dtype, seed=0):
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    spec = build_registry_spec("transformer_lm", **GPT2_SMALL)
    model = model_from_json(spec, compute_dtype=compute_dtype)
    params = model.init(torch.Generator().manual_seed(seed))
    return model, params


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q / 100.0 * len(xs))) - 1)]


def phase_serving(card):
    import numpy as np
    from sparkflow_tpu_torch.ops import (flash_attention, paged_attention,
                                         reset_launch_counts)
    from sparkflow_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                             InferenceServer, ServingClient)
    model, params = _lm("bfloat16")
    eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    launches = {}
    try:
        cli = ServingClient(srv.url, timeout=300)
        rng = np.random.default_rng(0)
        # warm-up, before the counters are zeroed: one request per prefill
        # bucket (and a sampled one), so first-use library loads for each
        # matmul shape stay out of the measured burst
        for n in [max(1, b // 2 + 1) for b in eng.prefill_buckets]:
            cli.generate(rng.integers(0, 1000, n).tolist(), max_new_tokens=2,
                         temperature=0.5, top_k=8, seed=0)
        lens = (17, 64, 100, 128, 255, 300, 512, 700)
        prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
                   for n in lens]
        sampled = {2: 1234, 5: 99}                     # request -> seed
        results = [None] * len(prompts)

        def one(i):
            kw = {}
            if i in sampled:
                kw = dict(temperature=0.8, top_k=40, seed=sampled[i])
            results[i] = cli.generate(prompts[i], max_new_tokens=32, **kw)

        steps0 = eng.stats()["steps"]
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash_attention.launches,
                    "paged_attention": paged_attention.launches}
        for i, r in enumerate(results):
            if r is None or r["num_tokens"] != 32 or len(r["tokens"]) != 32 \
                    or r["finish_reason"] != "length":
                raise AssertionError(f"request {i} (prompt {lens[i]}): {r}")
        if not (launches["flash_fwd"] > 0 and launches["paged_attention"] > 0):
            raise AssertionError(f"a kernel was not launched: {launches}")
        ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
                for r in results]
        step_ms_p50 = eng.metrics.percentile(
            "serving/decode/step_ms", 50,
            window=eng.stats()["steps"] - steps0)
        # greedy replay: the prompt's full pages are in the prefix index now,
        # so this one runs the prefix-hit suffix path and must still land on
        # the same tokens
        g = cli.generate(prompts[0], max_new_tokens=32)
        if g["tokens"] != results[0]["tokens"]:
            raise AssertionError("greedy replay differs")
        # seeded replay: sampling must repeat on the same computation, so the
        # index is flushed first — a prefix hit computes the suffix with other
        # matmul shapes, and bf16 logits that differ in the last bit can
        # move a sampled token
        eng.kv.flush_prefix_index()
        s = cli.generate(prompts[2], max_new_tokens=32, temperature=0.8,
                         top_k=40, seed=sampled[2])
        if s["tokens"] != results[2]["tokens"]:
            raise AssertionError("seeded replay differs")
        h = cli.healthz()
        if h["status"] != "ok":
            raise AssertionError(f"healthz: {h['status']}")
        pages = h["decode"]["engine"]["kv"]["pages_used"]
        if pages != 0:
            raise AssertionError(f"pages_used {pages} after all retired")
    finally:
        srv.stop()
    gen = sum(r["num_tokens"] for r in results)
    summary = {"requests": len(results), "tokens_generated": gen,
               "wall_s": wall, "ttft_ms_p50": _pct(ttft, 50),
               "ttft_ms_p95": _pct(ttft, 95),
               "decode_tokens_per_s": gen / wall,
               "step_ms_p50": step_ms_p50,
               "launches": launches, "card": card}
    log("[serving] " + json.dumps(summary))
    return launches, eng


def phase_exactness(card):
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params = _lm(None, seed=1)
    eng = DecodeEngine(model, params, num_slots=4, page_size=16, seed=0,
                       prefix_cache=False)
    rng = np.random.default_rng(1)
    worst = 0.0
    for n in (40, 129, 300):
        prompt = rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
        info = eng.prefill(prompt, max_new_tokens=8)
        toks = [info["token"]]
        while len(toks) < 8:
            toks.extend(eng.step()[info["slot"]])
        eng.release(info["slot"])
        ids = list(prompt)
        with torch.inference_mode():
            kernel_logits, _ = model.prefill(
                params, torch.tensor([prompt], device="cuda"))
            for i in range(8):
                lg = model._forward(
                    params, {"input_ids": torch.tensor([ids], device="cuda")},
                    attention=attention_reference)["logits"][0, -1]
                if i == 0:
                    err = max_err(kernel_logits[0], lg)
                    worst = max(worst, err)
                    if not err < 1e-3:
                        raise AssertionError(f"prefill logits differ by "
                                             f"{err} (prompt {n})")
                ids.append(int(lg.argmax()))
        if toks != ids[n:]:
            raise AssertionError(f"prompt {n}: engine {toks} != dense "
                                 f"{ids[n:]}")
    log(f"[exactness] 3 prompts x 8 greedy tokens equal the dense float32 "
        f"forward; max |prefill logit delta| {worst:.3g} [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sparkflow_tpu_torch  # noqa: F401 - fails outside a checkout
    from sparkflow_tpu_torch.device import device_report
    card = card_line()
    log(f"[setup] {card}")
    try:
        phase_setup()
        flash_row, paged_row = phase_kernels(card)
        launches, eng = phase_serving(card)
        phase_profile(card, eng)
        del eng
        phase_exactness(card)
    except Exception:
        traceback.print_exc()
        return 1
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "sparkflow_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "sparkflow_tpu/ops/attention.py:196",
         "launches": launches["flash_fwd"], **flash_row},
        {"name": "paged_attention", "route": "cuda",
         "source": "sparkflow_tpu_torch/ops/csrc/paged_attention.cu",
         "replaces": "sparkflow_tpu/ops/attention.py:734",
         "launches": launches["paged_attention"], **paged_row},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
