#!/usr/bin/env python3
"""Drive the PyTorch port (``sparkflow_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Imports no JAX.
Phases — any failure exits nonzero with its traceback and prints no result:

1. set-up: the card's name and power limit; build the CUDA kernels from
   ``sparkflow_tpu_torch/ops/csrc`` and print ptxas's registers, shared
   memory and spills (a spill in a tensor-core — bf16 or 3xTF32 —,
   split-verify or cluster decode instantiation fails the phase);
2. kernels against their plain PyTorch versions at the serving path's
   shapes, in bfloat16 and float32 (``flash_fwd`` on the tensor cores in
   both: bf16, and 3xTF32 for float32), and their times beside the plain
   version's, the least time the card could take (``bound_ms``; for
   float32 work at the 3xTF32 tensor-core rate, 495 / 3 TFLOP/s, with the
   CUDA cores' 67 TFLOP/s bound beside it as ``bound_cuda_core_ms``) and, for
   flash, ``F.scaled_dot_product_attention`` as a yardstick only, with the
   achieved TFLOP/s and share of the bound (``bound_ms / ms``). ``ms``,
   ``plain_ms`` and ``library_ms`` are device times (CUDA-graph replays
   between CUDA events); ``call_ms`` in the detail line is the time per
   call as the host enqueues it one at a time. ``paged_attention`` runs at
   the decode step's operands and at one 1024-token slot (B=1), each with
   its empty slots exact zeros, a second launch bit-identical and, beside
   it, the yardstick ``verify_s1_ms``: ``paged_attention_verify`` at S=1
   with start = lengths - 1 over the same non-empty slots;
3. serving: a GPT-2-small-width ``transformer_lm`` (random weights from a
   seed, bf16 compute) behind ``DecodeEngine`` -> ``ContinuousBatcher`` ->
   ``InferenceServer``, eight concurrent ``ServingClient.generate`` calls;
   the kernels' launch counters are zeroed just before and read just after;
4. profile: ``torch.profiler`` over 20 decode steps with 8 live slots and
   over one 700-token prefill — device busy time, idle share, top kernels;
5. exactness: float32 with TF32 off, all 12 layers — the engine's greedy
   tokens equal the argmax of the dense full-sequence forward over the plain
   attention, and prefill logits agree within 1e-3;
6. backward kernels, on operands laid out as the training step lays them
   out (strided q/k/v views of one qkv permutation, a transposed dO): the
   forward's output and logsumexp against ``attention_reference``, then
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` against their plain versions, at
   the training shape (B=8, H=12, S=1024, D=64, causal), at S=128, at a
   ragged S=700 and on a non-causal key-padded batch, in bfloat16 and
   float32 (the float32 forward and backward run the 3xTF32 tensor-core
   kernels), with the same timings as phase 2 (the forward's too, at the
   training shape, with its TFLOP/s and share of the bound); ``library_ms``
   for the backward is that of
   ``F.scaled_dot_product_attention`` at the same shape (all three
   gradients in one call), timed by itself by CUDA-graph replay; each
   backward row also gives its achieved TFLOP/s and its share of the bound
   (``bound_ms / ms``), and in every case a second launch of each kernel
   must give the same bits (no atomics);
7. training: ``Trainer.fit`` on the GPT-2-small-width ``transformer_lm``
   (dropout 0.1, bf16 compute, adam, lr 3e-4) over 64 rows x 1024 tokens
   of a 1,000-id sub-vocabulary, batch 8: 8 epochs of one step each, each
   timed on the host clock at its ``loss_callback`` (after the trainer's
   host read of the loss); the launch counters and the peak-memory mark are
   reset just before and read just after (12 x steps for each attention
   kernel); the losses must be finite and fall; then one more step under
   ``torch.profiler``, with each attention kernel's calls and device time
   summed over every profiled event;
8. training exactness: float32, TF32 off, full width cut to 2 layers — one
   step's loss and gradients through the kernels (the backward in 3xTF32)
   equal those through the plain attention, and 3 adam steps' losses agree
   within 1e-4 relative;
9. the quantized and verify kernels against their plain versions at the
   decode step's shapes (verify: S = spec_k + 1 = 5 queries per slot,
   ragged starts incl. 0): ``paged_attention`` over int8 and fp8 pools with
   a page-head of scale 0 and a page rescaled mid-fill (as in phase 2: with
   bf16 queries also at one 1024-token slot, each beside the S=1 verify
   yardstick), and
   ``paged_attention_verify`` over the bf16/f32 pool and both quantized
   ones, bf16 and f32 queries, timed as in phase 2; verify also at one
   1024-token slot (start 1019), the longest walk; in every case a second
   launch must give the same bits;
10. speculative serving: the GPT-2-small-width engine with ``spec_k=4``
    (self-speculation through 6 of 12 layers) serves one burst as in
    phase 3 with (a) the bf16 pool and (b) ``kv_quant="int8"``; the
    counters are zeroed before each burst and read after: every step is
    speculative, the verify kernel launches 12 times and the draft's paged
    kernel 4 x 6 times a step, and the other pool layout's kernels never;
    then 5 spec steps with 8 live slots under ``torch.profiler``;
11. speculative exactness: float32, TF32 off, 12 layers — greedy tokens with
    ``spec_k=4`` (self-draft, and an external 6-layer draft) equal the
    spec-off engine's; with an int8 pool the card's tokens equal the same
    engine's on the CPU; ``kv_quant_error`` of int8 below 0.05;
12. estimator: the Spark ML surface on the card with no device asked for.
    (a) The reference suite's ``nn`` model on its overlapping Gaussians
    through ``SparkAsyncDL`` in a ``Pipeline``: fewer than 400 errors in
    400 rows (the reference's bar), and the pipeline saved and loaded
    predicts the same. (b) ``examples/bert_classifier.py`` at full width:
    BERT-base ``transformer_classifier`` in float32 (the estimator sets no
    compute dtype), ``Pipeline([OneHotEncoder, SparkAsyncDL])`` over 256
    rows x 512 tokens with a mask column, batch 32, 1 epoch (8 steps),
    weights in an npz side file; fit, then transform; the fit's wall
    time, training examples/s over the steps after the first (CUDA events
    after each step), transform examples/s, peak memory, the per-epoch
    losses (finite) and the kernels' launches, 12 a step for each of the
    three flash kernels in the fit and 12 a partition of ``flash_fwd`` in
    the transform, zeroed just before and read just after each; then one
    more training step under ``torch.profiler``. (c) The transform's probs
    and logits for 8 rows against a forward of the same weights through
    ``attention_reference``, float32, TF32 off; kernels 1-3 (all three on
    the tensor cores in 3xTF32) against their plain versions at the fit's
    shape (float32, B=32, H=12, S=512, D=64, non-causal, the first batch's
    masks), timed beside their bounds (the 3xTF32 one and the CUDA cores')
    and SDPA's forward and backward. The
    fit's training examples/s and the profiled step's device busy ms are
    the numbers a parent / change comparison reads;
13. predict: README's "Serve it online" path on phase 12's fitted weights —
    ``InferenceEngine(modelJson, modelWeights, input_name=["input_ids:0",
    "attention_mask:0"], output_name="probs:0", max_batch=32)`` behind
    ``InferenceServer(max_delay_ms=2.0)`` in four arms: (a) float32, (b)
    ``compute_dtype="bfloat16"``, (c) ``quantize="weight_only"``, (d)
    ``quantize="dynamic"``. Each serves 8 concurrent
    ``ServingClient.predict`` threads x 8 requests of 1-8 rows (sizes from
    a seed, masks ragged over 256-512 live tokens); the counters are zeroed
    before each burst and read after: ``flash_fwd`` 12 times a bucket call,
    nothing else. It prints rows/s, request p50/p95 ms, batch rows and
    padding waste from ``/metrics``, the ms of buckets 1, 8 and 32 (CUDA
    events around one eager call), a profile of a 32-row call, ``stats()``
    and peak memory. Each arm's every served answer against the card
    engine's own predict of the burst's rows outside the server, a seeded
    16-row sample of them against the same arm on the CPU port engine
    (probs, and logits over max(1, max |logit|); the int8 trees built on
    the card bit-equal to the CPU's), arm (a) against a forward through
    ``attention_reference`` (TF32 off, 1e-4). Then a port ``Trainer(publish_to=store)`` takes 2 steps on the
    same model, ``WeightWatcher.poll_once()`` moves arm (a) to version 1,
    and its probs equal a fresh engine's built from ``store.load()``;
    ``flash_fwd`` at the largest bucket in bf16 (B=32 S=512, a key mask)
    against its plain version, beside its bound and SDPA's time.

14. resilience and stream: README's text pipeline at BERT-base width
    (phase 12's configuration, float32, TF32 off). (a) 256 long synthetic
    reviews (200-700 words, ``examples/text_classifier.py``'s shape),
    ``build_vocab`` over them, the native WordPiece ids and masks at 512
    tokens against the pure-Python fallback's on 32 rows (the native
    library must have loaded), encode rows/s. (b) ``Pipeline([
    WordpieceEncoder, OneHotEncoder, SparkAsyncDL(fitMode="stream",
    checkpointDir, checkpointEvery=4)])`` over them, batch 32, 8 steps:
    the counters zeroed before and read after (12 a step for each flash
    kernel), finite losses, training examples/s with and without the
    saves, the step-4 and step-8 checkpoints verified by their manifests,
    each save's host ms and bytes; then the transform's accuracy. (c)
    ``Trainer.fit`` over the encoded rows, 2 epochs of 8 steps,
    ``checkpoint_every=1``: uninterrupted; preempted by SIGTERM in epoch 1
    and fitted again; crashed in epoch 2 and resumed in the fit
    (``resume_retries=1``) — both land on the uninterrupted fit's weights
    bit for bit (else their relative delta is printed and held to 1e-6).
    (d) The uninterrupted fit runs with ``trace_spans``: phase totals within
    10 % of its wall time, the save's share, MFU against
    ``device_peak_flops()`` (the bf16 peak, the JAX convention, though the
    step runs float32), the Chrome trace parsed. (e) One forward and
    backward of phase 7's GPT-2-small-width bf16 model at 8 x 1024 in
    ``remat`` False, "dots" and "full": peak memory above the step's start
    (full < dots < False), step ms, a profiled step's device busy ms and
    idle share, ``flash_fwd`` launches (12, 24, 24),
    "dots" and "full" loss and gradients against False's within the bf16
    backward tolerance.

Run order: 1, 2, 9, 6, 3, 4, 10, 5, 11, 7, 8, 12, 13, 14; a ``[time]`` line
gives each phase's wall time. The line before the last gives the card's name and
power limit; the last line is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``. Exits nonzero, printing no result, where
there is no CUDA card.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). A
# float32-accurate product is fastest as three TF32 tensor-core products
# (3xTF32): 495 / 3 TFLOP/s, above the CUDA cores' 67, which float32 rows
# also print as ``bound_cuda_core_ms`` (the rule of earlier float32 rows).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
CUDA_CORE_FLOPS = 67e12

FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# backward kernels: |kernel - plain| <= tol x max |plain|, per gradient
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_STEPS = 8
SPEC_K = 4
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


def time_sdpa_backward(q, k, v, dout, mask, causal: bool,
                       calls: int = 10, replays: int = 7) -> float:
    """The card's ms per call of ``F.scaled_dot_product_attention``'s
    backward (dQ, dK and dV in one call). Autograd runs a backward on its
    forward's stream, so the forward runs once on a side stream and the
    backward calls are captured from that stream into a CUDA graph (as
    ``torch.cuda.make_graphed_callables`` does), then replayed between CUDA
    events like ``time_device``."""
    import torch
    import torch.nn.functional as F
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                             is_causal=causal)

        def backward():
            torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)

        for _ in range(2):
            backward()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            backward()
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
    return sorted(times)[len(times) // 2] / calls


def _bound(nbytes: float, flops: float, dtype_name: str,
           peak: float = None):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / (peak or PEAK_FLOPS[dtype_name]) * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _rate(row, dtype_name: str) -> None:
    """Add ``bound_ms`` / ``bound_by`` from the row's bytes and flops, the
    achieved TFLOP/s and the share of the bound (``bound_ms / ms``); a
    float32 row also its bound at the CUDA cores' peak."""
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"], row["flops"],
                                              dtype_name)
    if dtype_name == "float32":
        row["bound_cuda_core_ms"] = _bound(row["bytes"], row["flops"],
                                           dtype_name, CUDA_CORE_FLOPS)[0]
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]


def _cuda_core_note(row) -> str:
    """``"; CUDA cores <ms>"`` for a row that has that bound, else ``""``."""
    if "bound_cuda_core_ms" not in row:
        return ""
    return f"; CUDA cores {row['bound_cuda_core_ms']:.5f}"


def _entry_name(line: str):
    """``name<args>`` of the kernel whose ptxas report ``line`` starts
    (``Compiling entry function '<mangled>'``), else None. The mangled name
    holds ``<length><name>I<args>EE``; the anonymous namespace's own mangled
    name holds digits too, so the length prefix is what finds the name, e.g.
    ``..._cu_ddd79eae24flash_bwd_dq_tf32_kernelILi64EE`` ->
    ``flash_bwd_dq_tf32_kernel<Li64>``."""
    if "entry function" not in line:
        return None
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel)I(\w+?)EE)", line):
        if int(m.group(1)) == len(m.group(2)):
            return f"{m.group(2)}<{m.group(3)}>"
    return None


def phase_setup():
    from sparkflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[setup] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled, name = [], None
    for src, lines in _build.ptxas_report().items():
        log(f"[setup] ptxas {src}:")
        for ln in lines:
            entry = _entry_name(ln)
            if entry:
                name = entry
                log(f"  {name}")
            elif "registers" in ln or "spill" in ln:
                log("   ", ln.split(":", 1)[-1].strip())
                if re.search(r"[1-9]\d* bytes spill", ln):
                    spilled.append(name)
    log(f"[setup] instantiations that spill: {spilled or 'none'}")
    # the tensor-core (bf16 and 3xTF32), the split verify and the cluster
    # decode kernels are held to no spill
    held = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
            "flash_fwd_tf32", "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32",
            "paged_verify_split", "paged_verify_combine",
            "paged_attention_kernel")
    bad = [n for n in spilled if n and n.startswith(held)]
    if bad:
        raise AssertionError(f"ptxas spills registers in {bad}")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels(card):
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import attention_reference, flash_attention
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
            _rate(row, dn)
            flash_rows.append(row)
            log(f"[kernels] flash_fwd {dn} B=1 H=12 S={s} D=64 causal: "
                f"err {e:.3g} lse_err {el:.3g} ms {row['ms']:.5f} (per "
                f"call {row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                f"sdpa {row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
                f"({row['bound_by']}{_cuda_core_note(row)}) "
                f"{row['tflops']:.1f} TFLOP/s, "
                f"{row['bound_share']:.3f} of the bound [{card}]")
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

    # -- paged attention: the decode step's shapes, and one long slot -------
    b, h, d, page, maxp, num_pages = DECODE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        kp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        vp = torch.randn(num_pages, page, h, d, generator=g,
                         device=dev).to(dtype)
        for case in ("decode", "one-slot"):
            row = _decode_row(card, "kernels", q, kp, vp, {}, case)
            paged_err = max(paged_err, row["max_abs_err"])
            paged_rows.append(row)
    log("[kernels] detail " + json.dumps({"flash_fwd": flash_rows,
                                          "paged_attention": paged_rows}))
    # the kernels line reports the serving phase's own shapes: bf16, the
    # largest prefill bucket for flash, the decode step for paged
    main_flash = next(r for r in flash_rows
                      if r["dtype"] == "bfloat16" and r["S"] == 1024)
    return ({"max_abs_err": flash_err, **_pick(main_flash),
             "tflops": main_flash["tflops"],
             "bound_share": main_flash["bound_share"]},
            {"max_abs_err": paged_err, **_decode_pick(paged_rows, "bfloat16")})


# the decode step's paged operands: B, H, D, page, max pages, pool pages
DECODE_SHAPE = (8, 12, 64, 16, 64, 513)
DECODE_LENGTHS = (0, 1, 17, 100, 255, 512, 700, 1024)


def _decode_operands(dev):
    """``(lengths, table)`` of the paged kernels' rows: ragged lengths with
    an empty slot (its table row on scratch page 0) and slot 3 aliasing
    slot 2's first two pages (a shared prefix)."""
    import numpy as np
    import torch
    b, _, _, _, maxp, num_pages = DECODE_SHAPE
    rs = np.random.RandomState(0)
    table = rs.permutation(np.arange(1, num_pages))[:b * maxp].reshape(b, maxp)
    table[3, :2] = table[2, :2]                   # aliased shared prefix
    table[0] = 0                                  # empty slot -> scratch page
    return (torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev),
            torch.as_tensor(table, dtype=torch.int32, device=dev))


def _pool_rows(table, walked, page):
    """The (page, row) pool rows a kernel reads when slot i walks its first
    ``walked[i]`` tokens, each counted once (aliased pages are one set)."""
    tab = table.tolist()
    return {(tab[i][t // page], t % page)
            for i, n in enumerate(walked.tolist()) for t in range(n)}


def _pick(row):
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}


def _decode_row(card, tag, q, kp, vp, sc, case):
    """Check and time ``paged_attention`` over the pool ``kp``/``vp`` (with
    scales ``sc``, when quantized) at the decode step's operands
    (``case="decode"``) or at one 1024-token slot, B=1 (``"one-slot"``, slot
    7's table row: one block per (slot, head) walked it all before the walk
    was split). Against the plain version within ``PAGED_TOL``, an empty
    slot exact zeros, a second launch bit-identical. Timed with the pool
    cold in L2, beside the yardstick ``verify_s1_ms``:
    ``paged_attention_verify`` at S=1 with start = lengths - 1 over the
    same non-empty slots (the split verify and its combine, two launches).
    Returns the detail row."""
    import torch
    from sparkflow_tpu_torch.ops import (paged_attention,
                                         paged_attention_reference,
                                         paged_attention_verify)
    _, h, d, page, _, _ = DECODE_SHAPE
    lengths, table = _decode_operands(q.device)
    if case == "one-slot":
        q, table = q[7:8], table[7:8]
        lengths = torch.tensor([1024], dtype=torch.int32, device=q.device)
    dn = str(q.dtype).replace("torch.", "")
    name = "paged_attention_quant" if sc else "paged_attention"
    pool_name = dn if not sc else ("int8" if kp.dtype == torch.int8
                                   else "fp8")
    out, ref, again = (paged_attention(q, kp, vp, table, lengths, **sc),
                       paged_attention_reference(q, kp, vp, table, lengths,
                                                 **sc),
                       paged_attention(q, kp, vp, table, lengths, **sc))
    torch.cuda.synchronize()
    e = max_err(out, ref)
    empty_zero = bool(torch.all(out[lengths == 0] == 0))
    if not (e < PAGED_TOL[dn] and empty_zero
            and bool(torch.isfinite(out.float()).all())):
        raise AssertionError(f"{name} {dn} q, {pool_name} pool, {case}: max "
                             f"|d| {e} (tol {PAGED_TOL[dn]}); empty slot "
                             f"zero: {empty_zero}")
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {dn} q, {pool_name} pool, {case}: a "
                             f"second launch gave other bits")
    rows = _pool_rows(table, lengths, page)
    npages = len({p for p, _ in rows})
    item = kp.element_size()
    qbytes = q.numel() * q.element_size()
    # K and V rows read once (and one float32 scale per page-head of the
    # pages read), q read and O written, table and lengths
    nbytes = (2 * len(rows) * h * d * item + (2 * npages * h * 4 if sc else 0)
              + 2 * qbytes + table.numel() * 4 + lengths.numel() * 4)
    flops = 4 * h * d * int(lengths.sum())
    # in a decode step the layer's pool comes cold from device memory
    # (between two layers' calls the step streams a layer's weights, 7M
    # parameters read as float32 and cast to bf16): time launches over
    # enough copies of the pool that more than the 50 MB L2 of live rows
    # lies between two visits of one copy (12 at 2 bytes an element)
    copies = 12 * 2 // item if item < 4 else 12
    pools = [(kp.clone(), vp.clone(), {k: v.clone() for k, v in sc.items()})
             for _ in range(copies)]
    live = lengths > 0
    qv, tv = q[live][:, :, None], table[live]
    start = (lengths[live] - 1).to(torch.int32)
    row = {"kernel": name, "dtype": dn, "pool": pool_name, "case": case,
           "B": q.shape[0], "tokens": int(lengths.sum()), "max_abs_err": e,
           "ms": time_device([
               lambda p=p: paged_attention(q, p[0], p[1], table, lengths,
                                           **p[2]) for p in pools]),
           "call_ms": time_calls(lambda: paged_attention(q, kp, vp, table,
                                                         lengths, **sc)),
           "verify_s1_ms": time_device([
               lambda p=p: paged_attention_verify(qv, p[0], p[1], tv, start,
                                                  **p[2]) for p in pools]),
           "plain_ms": time_device([
               lambda p=p: paged_attention_reference(q, p[0], p[1], table,
                                                     lengths, **p[2])
               for p in pools[:12]]),
           "library_ms": None, "bytes": nbytes, "flops": flops}
    del pools
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
    log(f"[{tag}] {name} {dn} q, {pool_name} pool, {case} B={row['B']} H={h} "
        f"D={d} page={page} tokens {row['tokens']}: err {e:.3g} ms "
        f"{row['ms']:.5f} (per call {row['call_ms']:.4f}) verify S=1 "
        f"{row['verify_s1_ms']:.5f} plain {row['plain_ms']:.4f} bound "
        f"{row['bound_ms']:.5f} ({row['bound_by']}); empty slot 0, a second "
        f"launch bit-identical [{card}]")
    return row


def _decode_pick(rows, pool_name):
    """The kernels-line fields of a decode kernel: its bf16-query row at the
    decode step's shape, with the yardstick and the one-slot row's times."""
    main, one = (next(r for r in rows if r["dtype"] == "bfloat16"
                      and r["pool"] == pool_name and r["case"] == case)
                 for case in ("decode", "one-slot"))
    return {**_pick(main), "verify_s1_ms": main["verify_s1_ms"],
            "one_slot": {k: one[k] for k in ("ms", "verify_s1_ms",
                                             "bound_ms")}}


def _device_profile(prof, wall_ms: float, per: int,
                    kernels: tuple = ()) -> dict:
    """The card's share of a profiled window: the union of its kernel, copy
    and memset intervals (GPU-side ``record_function`` ranges excluded)
    against the window's host wall time, the kernels that took most of it
    and, for each name fragment in ``kernels``, the calls and time of every
    kernel whose name holds it, all per ``per`` (steps or prefills)."""
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
    out = {"wall_ms": wall_ms / per, "device_busy_ms": busy_ms / per,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops": len(evs) / per,
           "top": [{"name": n[:90], "calls": c / per, "ms": us / 1e3 / per}
                   for n, (c, us) in top]}
    if kernels:
        out["kernels"] = {
            frag: {"calls": sum(c for n, (c, _) in by_name.items()
                                if frag in n) / per,
                   "ms": sum(us for n, (_, us) in by_name.items()
                             if frag in n) / 1e3 / per}
            for frag in kernels}
    return out


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


def _quant_pools(kp, vp, kind, zero_page, grow_page):
    """K and V ``(rows, scales)`` of float pools quantized to ``kind``
    ("int8" / "fp8") as the engine's pool holds them: head 3 of
    ``zero_page`` all zeros (scale 0, never written), and ``grow_page``
    rescaled mid-fill — a late row with 3x the page's absmax appended at
    offset 7 through the running-scale path."""
    import torch
    from sparkflow_tpu_torch.utils import quant
    out = []
    for pages in (kp, vp):
        pages = pages.float().clone()
        pages[zero_page, :, 3] = 0.0
        rows, scales = quant.quantize_kv_pages(pages, kind)
        rows, scales = rows[None].contiguous(), scales[None].contiguous()
        dev = pages.device
        quant.paged_quant_append(
            rows, scales, 0, torch.tensor([grow_page], device=dev),
            torch.tensor([7], device=dev), 3.0 * pages[grow_page, 7:8])
        if float(scales[0, zero_page, 3]) != 0.0:
            raise AssertionError("the zeroed page-head has a scale")
        out.append((rows[0], scales[0]))
    return out


def phase_spec_kernels(card):
    """Kernels 5-7 against their plain versions at the decode step's shapes
    (B=8, H=12, D=64, page 16, the paged row's 2609 live tokens; verify
    S=5): ``paged_attention`` over int8 and fp8 pools, ``paged_attention_
    verify`` over the plain pool and both quantized ones, bf16 and f32
    queries; each timed like the paged row (pool cold in L2). Returns the
    kernels-line rows (bf16 queries; int8 for the quantized kernels)."""
    import torch
    from sparkflow_tpu_torch.ops import (paged_attention_verify,
                                         paged_attention_verify_reference)
    dev = torch.device("cuda")
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    b, h, d, page, maxp, num_pages = DECODE_SHAPE
    lengths, table = _decode_operands(dev)
    zero_page, grow_page = int(table[5, 0]), int(table[6, 1])
    S = SPEC_K + 1
    start = (lengths - S).clamp(min=0).to(torch.int32)
    # verify's operands: the decode step's slots, and one 1024-token slot
    # (slot 7's table row, start 1019) — one block walked it all before
    # the walk was split into chunks
    one = torch.tensor([1024 - S], dtype=torch.int32, device=dev)
    slots = {"verify": (table, start + S), "one-slot": (table[7:8], one + S)}
    rows = {k: _pool_rows(t, walked, page) for k, (t, walked) in
            slots.items()}
    pages = {k: len({p for p, _ in r}) for k, r in rows.items()}
    # (query, key) pairs: every key at or before the query's position
    pairs = {k: sum(int(st) * S + S * (S + 1) // 2 for st in sv.tolist())
             for k, sv in (("verify", start), ("one-slot", one))}
    detail, worst = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        g = torch.Generator(device=dev).manual_seed(5)
        kp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
        vp = torch.randn(num_pages, page, h, d, generator=g, device=dev)
        q1 = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        # the verify query as the model hands it over: a strided view of
        # one [B, S, 3, H, D] qkv projection
        qs = torch.randn(b, S, 3, h, d, generator=g, device=dev).to(dtype)
        qs = qs.permute(2, 0, 3, 1, 4)[0]
        # the decode kernel over both quantized pools; the one-slot case
        # with bf16 queries
        for kind in ("int8", "fp8"):
            (kq, ks), (vq, vs) = _quant_pools(kp, vp, kind, zero_page,
                                              grow_page)
            for case in ("decode", "one-slot")[:2 if dtype ==
                                                torch.bfloat16 else 1]:
                row = _decode_row(card, "spec-kernels", q1, kq, vq,
                                  dict(k_scales=ks, v_scales=vs), case)
                row["S"] = 1
                worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0),
                                           row["max_abs_err"])
                detail.append(row)
        cases = [("paged_verify", None, dn, "verify")]
        cases += [("paged_verify_quant", kind, kind, "verify") for kind in
                  ("int8", "fp8")]
        if dtype == torch.bfloat16:
            cases += [("paged_verify", None, dn, "one-slot")]
            cases += [("paged_verify_quant", kind, kind, "one-slot")
                      for kind in ("int8", "fp8")]
        for name, kind, pool_name, shape in cases:
            if kind is None:
                pool = (kp.to(dtype), None), (vp.to(dtype), None)
            else:
                pool = _quant_pools(kp, vp, kind, zero_page, grow_page)
            (kq, ks), (vq, vs) = pool
            sc = {} if kind is None else dict(k_scales=ks, v_scales=vs)
            tab = slots[shape][0]
            q, per_slot = {"verify": (qs, start),
                           "one-slot": (qs[7:8], one)}[shape]

            def call(kk, vv, sc, q=q, tab=tab, per_slot=per_slot):
                return paged_attention_verify(q, kk, vv, tab, per_slot, **sc)

            def plain(kk, vv, sc, q=q, tab=tab, per_slot=per_slot):
                return paged_attention_verify_reference(q, kk, vv, tab,
                                                        per_slot, **sc)

            out, ref, again = (call(kq, vq, sc), plain(kq, vq, sc),
                               call(kq, vq, sc))
            torch.cuda.synchronize()
            e = max_err(out, ref)
            if not (e < PAGED_TOL[dn] and bool(torch.isfinite(
                    out.float()).all())):
                raise AssertionError(f"{name} {dn} q, {pool_name} pool, "
                                     f"{shape}: max |d| {e} (tol "
                                     f"{PAGED_TOL[dn]})")
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {dn} q, {pool_name} pool, "
                                     f"{shape}: a second launch gave other "
                                     f"bits")
            worst[name] = max(worst.get(name, 0.0), e)
            item = kq.element_size()
            qbytes = q.numel() * q.element_size()
            # K and V rows read once (and one float32 scale per page-head
            # of the pages read), q read and O written, table and start
            nbytes = (2 * len(rows[shape]) * h * d * item
                      + (2 * pages[shape] * h * 4 if kind else 0)
                      + 2 * qbytes + tab.numel() * 4 + per_slot.numel() * 4)
            flops = 4 * h * d * pairs[shape]
            # cold in L2 as in a decode step: enough pool copies that more
            # than the 50 MB L2 of live rows lies between two visits of one
            copies = 12 * 2 // item if item < 4 else 12
            pools = [(kq.clone(), vq.clone(), {k: v.clone() for k, v in
                                               sc.items()})
                     for _ in range(copies)]
            row = {"kernel": name, "dtype": dn, "pool": pool_name,
                   "case": shape, "B": q.shape[0], "S": S,
                   "tokens": int(slots[shape][1].sum()),
                   "max_abs_err": e,
                   "ms": time_device([lambda p=p: call(*p) for p in pools]),
                   "call_ms": time_calls(lambda: call(kq, vq, sc)),
                   "plain_ms": time_device([lambda p=p: plain(*p)
                                            for p in pools[:12]]),
                   "library_ms": None, "bytes": nbytes, "flops": flops}
            del pools
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dn)
            detail.append(row)
            log(f"[spec-kernels] {name} {dn} q, {pool_name} pool, "
                f"B={row['B']} H=12 D=64 page=16 S={row['S']} tokens "
                f"{row['tokens']}: err {e:.3g} ms {row['ms']:.5f} (per call "
                f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} bound "
                f"{row['bound_ms']:.5f} ({row['bound_by']}); a second launch "
                f"bit-identical [{card}]")
    log("[spec-kernels] detail " + json.dumps(detail))
    picked = {"paged_attention_quant": {
        "max_abs_err": worst["paged_attention_quant"],
        **_decode_pick(detail, "int8")}}
    for name, pool_name in (("paged_verify", "bfloat16"),
                            ("paged_verify_quant", "int8")):
        main = next(r for r in detail if r["kernel"] == name
                    and r["dtype"] == "bfloat16" and r["pool"] == pool_name
                    and r["case"] != "one-slot")
        picked[name] = {"max_abs_err": worst[name], **_pick(main)}
    return picked


def _serve_burst(eng, seed: int):
    """Eight concurrent ``generate`` calls (the serving phase's prompt
    lengths, 32 new tokens, two of them sampled) through
    ``ContinuousBatcher`` -> ``InferenceServer`` -> ``ServingClient``, after
    one warm-up request per prefill bucket. The launch counters are zeroed
    just before the burst and read just after. Returns ``(results, wall
    seconds, launch counts, engine steps in the burst)``."""
    import numpy as np
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import (ContinuousBatcher,
                                             InferenceServer, ServingClient)
    cb = ContinuousBatcher(eng, max_queue=64)
    srv = InferenceServer(None, generate_batcher=cb, host="127.0.0.1",
                          port=0, memory_watch=False).start()
    try:
        cli = ServingClient(srv.url, timeout=300)
        rng = np.random.default_rng(seed)
        for n in [max(1, bk // 2 + 1) for bk in eng.prefill_buckets]:
            cli.generate(rng.integers(0, 1000, n).tolist(), max_new_tokens=2,
                         temperature=0.5, top_k=8, seed=0)
        lens = (17, 64, 100, 128, 255, 300, 512, 700)
        prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
                   for n in lens]
        sampled = {2: 1234, 5: 99}
        results = [None] * len(prompts)

        def one(i):
            kw = {}
            if i in sampled:
                kw = dict(temperature=0.8, top_k=40, seed=sampled[i])
            results[i] = cli.generate(prompts[i], max_new_tokens=32, **kw)

        st0 = eng.stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        st1 = eng.stats()
        for i, r in enumerate(results):
            if r is None or r["num_tokens"] != 32 or len(r["tokens"]) != 32 \
                    or r["finish_reason"] != "length":
                raise AssertionError(f"request {i} (prompt {lens[i]}): {r}")
        h = cli.healthz()
        if h["status"] != "ok" or h["decode"]["engine"]["kv"][
                "pages_used"] != 0:
            raise AssertionError(f"healthz after the burst: {h['status']}, "
                                 f"pages_used "
                                 f"{h['decode']['engine']['kv']['pages_used']}")
    finally:
        srv.stop()
    return results, wall, launches, {
        "steps": st1["steps"] - st0["steps"],
        "spec_steps": st1["spec"]["steps"] - st0["spec"]["steps"]}


def _profile_steps(eng, steps: int = 5) -> dict:
    """``torch.profiler`` over ``steps`` engine steps with all 8 slots live
    (the profile phase's prompt lengths), after two unprofiled ones."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    slots = [eng.prefill(rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist(),
                         max_new_tokens=200)["slot"]
             for n in (17, 64, 100, 128, 255, 300, 512, 700)]
    for _ in range(2):
        eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    for s in slots:
        eng.release(s)
    return {"steps": steps, **_device_profile(prof, wall, steps)}


def phase_spec_serving(card):
    """The speculative decode plane at GPT-2-small width (bf16, random
    weights from a seed): ``DecodeEngine(num_slots=8, page_size=16,
    spec_k=4)`` — self-speculation through the first 6 of 12 layers — with
    (a) the bf16 pool and (b) ``kv_quant="int8"``, each serving one burst,
    then 5 spec steps with 8 live slots under ``torch.profiler``. Returns
    the launch counts of both bursts."""
    from sparkflow_tpu_torch.serving import DecodeEngine
    model, params = _lm("bfloat16")
    layers = model.num_layers
    out = {}
    for arm, kw in (("a", {}), ("b", {"kv_quant": "int8"})):
        eng = DecodeEngine(model, params, num_slots=8, page_size=16, seed=0,
                           spec_k=SPEC_K, **kw)
        results, wall, launches, steps = _serve_burst(eng, seed=10)
        st = eng.stats()
        quantized = arm == "b"
        draft_key = "paged_attention_quant" if quantized else "paged_attention"
        verify_key = "paged_verify_quant" if quantized else "paged_verify"
        others = ("paged_attention", "paged_verify") if quantized else (
            "paged_attention_quant", "paged_verify_quant")
        n = steps["spec_steps"]
        if not (n > 0 and n == steps["steps"]
                and launches[verify_key] == layers * n
                and launches[draft_key] == SPEC_K * eng.draft_layers * n
                and launches["flash_fwd"] > 0
                and all(launches[k] == 0 for k in others)):
            raise AssertionError(
                f"burst ({arm}): {steps}, launches {launches}: every step "
                f"must be speculative, {verify_key} {layers} per step, "
                f"{draft_key} {SPEC_K} x {eng.draft_layers} per step, "
                f"{', '.join(others)} never")
        ttft = [r["timing_ms"]["queue_wait_ms"] + r["timing_ms"]["prefill_ms"]
                for r in results]
        gen = sum(r["num_tokens"] for r in results)
        spec = st["spec"]
        summary = {
            "arm": arm, "kv_quant": st["kv_quant"], "spec_k": SPEC_K,
            "draft_layers": eng.draft_layers, "requests": len(results),
            "tokens_generated": gen, "wall_s": wall,
            "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p95": _pct(ttft, 95),
            "decode_tokens_per_s": gen / wall,
            "spec_steps": n, "accept_rate": spec["accept_rate"],
            "mean_accepted": spec["mean_accepted"],
            "draft_ms_p50": eng.metrics.percentile(
                "serving/decode/draft_ms", 50, window=n),
            "verify_ms_p50": eng.metrics.percentile(
                "serving/decode/verify_ms", 50, window=n),
            "step_ms_p50": eng.metrics.percentile(
                "serving/decode/step_ms", 50, window=n),
            "kv_bytes_per_page": st["kv"]["kv_bytes_per_page"],
            "kv_quant_error": st["kv_quant_error"],
            "launches": launches, "card": card}
        log("[spec-serving] " + json.dumps(summary))
        log("[spec-profile] " + json.dumps(
            {"arm": arm, "spec_step_8_slots": _profile_steps(eng),
             "card": card}))
        out[arm] = (launches, summary)
        del eng
    bf16, int8 = (out[a][1]["kv_bytes_per_page"] for a in ("a", "b"))
    log(f"[spec-serving] KV bytes per page ({layers} layers, K and V): bf16 "
        f"{bf16}, "
        f"int8 {int8} ({bf16 / int8:.3f}x as many pages per byte)")
    return {arm: launches for arm, (launches, _) in out.items()}


def _greedy(eng, prompts, n):
    """``n`` greedy tokens for each prompt, all admitted at once; a slot is
    released as soon as it has its ``n`` (a speculative step may give some
    slots several tokens and others one)."""
    infos = [eng.prefill(p, max_new_tokens=n) for p in prompts]
    toks = {i["slot"]: [i["token"]] for i in infos}
    live = set(toks)
    while live:
        for s, t in eng.step().items():
            toks[s].extend(t)
            if len(toks[s]) >= n:
                eng.release(s)
                live.discard(s)
    return [toks[i["slot"]][:n] for i in infos]


def phase_spec_exactness(card):
    """Float32, TF32 off, all 12 layers: greedy tokens with ``spec_k=4``
    (self-speculation, and an external 6-layer 768-wide draft of the same
    vocab) equal the spec-off engine's; with an int8 pool and ``spec_k=4``
    the card's tokens equal the same engine's on the CPU (its plain
    versions) over 4 prompts x 16 tokens; ``kv_quant_error`` of int8 below
    0.05 (fp8's printed)."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec, model_from_json
    from sparkflow_tpu_torch.serving import DecodeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params = _lm(None, seed=1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, GPT2_SMALL["vocab_size"], n).tolist()
               for n in (20, 57, 100, 150)]
    kw = dict(num_slots=4, page_size=16, max_seq_len=256, seed=0,
              prefix_cache=False)
    want = _greedy(DecodeEngine(model, params, **kw), prompts, 16)
    draft_spec = build_registry_spec("transformer_lm",
                                     **dict(GPT2_SMALL, num_layers=6))
    draft = model_from_json(draft_spec)
    draft_params = draft.init(torch.Generator().manual_seed(2))
    accept = {}
    for name, extra in (("self", {}),
                        ("external", dict(draft_model=draft_spec,
                                          draft_params=draft_params))):
        eng = DecodeEngine(model, params, spec_k=SPEC_K, **kw, **extra)
        got = _greedy(eng, prompts, 16)
        if got != want:
            raise AssertionError(f"spec_k={SPEC_K} ({name} draft) tokens "
                                 f"{got} != spec-off {want}")
        accept[name] = eng.stats()["spec"]["accept_rate"]
    card_eng = DecodeEngine(model, params, spec_k=SPEC_K, kv_quant="int8",
                            **kw)
    card_toks = _greedy(card_eng, prompts, 16)
    cpu_model = model_from_json(build_registry_spec("transformer_lm",
                                                    **GPT2_SMALL),
                                device="cpu")
    cpu_params = {ln: {pn: t.cpu() for pn, t in layer.items()}
                  for ln, layer in params.items()}
    cpu_eng = DecodeEngine(cpu_model, cpu_params, spec_k=SPEC_K,
                           kv_quant="int8", **kw)
    cpu_toks = _greedy(cpu_eng, prompts, 16)
    if card_toks != cpu_toks:
        raise AssertionError(f"int8 + spec_k={SPEC_K}: card {card_toks} != "
                             f"CPU engine {cpu_toks}")
    err = card_eng.stats()["kv_quant_error"]
    if not (err is not None and 0.0 <= err < 0.05):
        raise AssertionError(f"kv_quant_error (int8) {err}, not below 0.05")
    fp8_err = DecodeEngine(model, params, kv_quant="fp8",
                           **kw).stats()["kv_quant_error"]
    log(f"[spec-exactness] float32, 12 layers, 4 prompts x 16 greedy tokens: "
        f"spec_k={SPEC_K} self-draft (accept {accept['self']:.3f}) and "
        f"external 6-layer draft (accept {accept['external']:.3f}) equal "
        f"spec-off; int8 + spec_k={SPEC_K} card equals the CPU engine; "
        f"kv_quant_error int8 {err:.4g} (CPU {cpu_eng.stats()['kv_quant_error']:.4g}),"
        f" fp8 {fp8_err:.4g} [{card}]")


def _training_operands(b, s, dtype, gen):
    """q, k, v and dO laid out as the training step hands them to the
    kernels: q, k and v strided views of one [3,B,H,S,D] permutation of the
    qkv projection's [B,S,3,H,D] output, dO the [B,H,S,D] view of a
    [B,S,H,D] tensor (the gradient of the forward's transpose back)."""
    import torch
    qkv = torch.randn(b, s, 3, 12, 64, generator=gen, device="cuda").to(dtype)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    dout = torch.randn(b, s, 12, 64, generator=gen, device="cuda").to(dtype)
    return qkv[0], qkv[1], qkv[2], dout.transpose(1, 2)


def phase_backward_kernels(card):
    """The forward's output and logsumexp, then the dq and dk/dv kernels,
    against their plain versions at the training path's operands; and their
    times. Returns the kernels-line rows: bf16 at the training shape for the
    two backward kernels and for the forward."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                         flash_attention_backward_reference,
                                         flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    cases = [("train", 8, 1024, True, None), ("s128", 2, 128, True, None),
             ("s700", 1, 700, True, None),
             # the classifier's mask: padded tails, one row all padding
             ("masked", 4, 512, False, (512, 300, 77, 0))]
    rows, fwd_rows = [], []
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dn = names[dtype]
        for case, b, s, causal, first_pad in cases:
            g = torch.Generator(device=dev).manual_seed(s + b)
            q, k, v, dout = _training_operands(b, s, dtype, g)
            mask = None
            if first_pad is not None:
                mask = torch.ones(b, s, device=dev)
                for i, f in enumerate(first_pad):
                    mask[i, f:] = 0
            out, lse = flash_attention(q, k, v, causal=causal, kv_mask=mask,
                                       return_lse=True)
            ref_out, ref_lse = attention_reference(q, k, v, causal,
                                                   kv_mask=mask,
                                                   return_lse=True)
            torch.cuda.synchronize()
            # a row whose keys are all padding has lse at NEG_INF on both
            # sides (the backward's gate zeroes its P): compare the others
            live = ref_lse > -0.5e30
            e = max_err(out, ref_out)
            el = max_err(lse[live], ref_lse[live])
            if not (e < FLASH_TOL[dn] and el < LSE_TOL[dn]
                    and bool((lse[~live] <= -0.5e30).all())):
                raise AssertionError(
                    f"flash_fwd {dn} {case}: max |dO| {e} (tol "
                    f"{FLASH_TOL[dn]}), max |dlse| {el} (tol {LSE_TOL[dn]}), "
                    f"all-padding rows at NEG_INF: "
                    f"{bool((lse[~live] <= -0.5e30).all())}")
            worst["flash_fwd"] = max(worst["flash_fwd"], e)
            log(f"[bwd] flash_fwd {dn} {case} B={b} S={s}: err {e:.3g} "
                f"lse_err {el:.3g}")
            if case == "train":
                # q, k, v read once, O written once; QK^T and PV over the
                # causal (query, key) pairs
                nbytes = 4 * q.numel() * q.element_size()
                flops = 4 * 64 * 12 * b * s * (s + 1) / 2
                kern = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
                row = {"dtype": dn, "case": case, "B": b, "S": s,
                       "max_abs_err": e, "lse_err": el,
                       "ms": time_device([kern] * 10),
                       "call_ms": time_calls(kern),
                       "plain_ms": time_device([lambda: attention_reference(
                           q, k, v, causal=True)] * 2),
                       "library_ms": time_device([
                           lambda: F.scaled_dot_product_attention(
                               q, k, v, is_causal=True)] * 10),
                       "bytes": nbytes, "flops": flops}
                _rate(row, dn)
                fwd_rows.append(row)
                log(f"[bwd] flash_fwd {dn} train B={b} H=12 S={s} D=64 "
                    f"causal: ms {row['ms']:.5f} (per call "
                    f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                    f"sdpa {row['library_ms']:.5f} bound "
                    f"{row['bound_ms']:.5f} ({row['bound_by']}"
                    f"{_cuda_core_note(row)}) "
                    f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} "
                    f"of the bound [{card}]")
            del ref_out, ref_lse
            delta = (dout.float() * out.float()).sum(-1).contiguous()
            args = (q, k, v, dout, lse, delta, causal)
            dq = flash_bwd_dq(*args, kv_mask=mask)
            dk, dv = flash_bwd_dkv(*args, kv_mask=mask)
            ref = flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                     causal, kv_mask=mask)
            torch.cuda.synchronize()
            errs = {}
            for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                e, top = max_err(a, r), float(r.float().abs().max())
                if not (e <= BWD_TOL[dn] * top and torch.isfinite(
                        a.float()).all()):
                    raise AssertionError(
                        f"flash_bwd {gname} {dn} {case}: max |d| {e} > "
                        f"{BWD_TOL[dn]} x max |plain| {top}")
                errs[gname] = e
            if mask is not None and not (torch.all(dq[3] == 0)
                                         and torch.all(dk[3] == 0)):
                raise AssertionError(f"flash_bwd {dn}: the all-padding row's "
                                     f"gradient is not zero")
            again = (flash_bwd_dq(*args, kv_mask=mask),
                     *flash_bwd_dkv(*args, kv_mask=mask))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv),
                                                         again)):
                raise AssertionError(f"flash_bwd {dn} {case}: a second "
                                     f"launch gave other bits")
            del again
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])
            # the (query, key) pairs this run's data needs: at or below the
            # diagonal when causal, the unpadded keys otherwise
            if causal:
                pairs = 12 * b * s * (s + 1) / 2
            else:
                pairs = 12 * s * float(mask.sum()) if mask is not None \
                    else 12 * b * s * s
            item = q.element_size()
            plane = q.numel() * item            # one [B,H,S,D] operand
            stats = 2 * b * 12 * s * 4          # lse and delta, float32
            mbytes = mask.numel() * 4 if mask is not None else 0
            library_ms = time_sdpa_backward(q, k, v, dout, mask, causal)
            for name, kern, plain, nbytes, products in (
                    ("flash_bwd_dq",
                     lambda: flash_bwd_dq(*args, kv_mask=mask),
                     lambda: flash_bwd_dq_reference(*args, None, mask),
                     5 * plane + stats + mbytes, 3),
                    ("flash_bwd_dkv",
                     lambda: flash_bwd_dkv(*args, kv_mask=mask),
                     lambda: flash_bwd_dkv_reference(*args, None, mask),
                     6 * plane + stats + mbytes, 4)):
                flops = products * 2 * 64 * pairs
                row = {"kernel": name, "dtype": dn, "case": case, "B": b,
                       "S": s, "causal": causal,
                       "max_abs_err": (errs["dq"] if name == "flash_bwd_dq"
                                       else max(errs["dk"], errs["dv"])),
                       "ms": time_device([kern] * 10),
                       "call_ms": time_calls(kern),
                       "plain_ms": time_device([plain] * 2),
                       "library_ms": library_ms,
                       "bytes": nbytes, "flops": flops}
                _rate(row, dn)
                rows.append(row)
                log(f"[bwd] {name} {dn} {case} B={b} H=12 S={s} D=64 "
                    f"{'causal' if causal else 'padded keys'}: err "
                    f"{row['max_abs_err']:.3g} ms {row['ms']:.5f} (per call "
                    f"{row['call_ms']:.4f}) plain {row['plain_ms']:.4f} "
                    f"bound {row['bound_ms']:.5f} ({row['bound_by']}"
                    f"{_cuda_core_note(row)}) {row['tflops']:.1f} TFLOP/s, "
                    f"{row['bound_share']:.3f} of the bound; sdpa-bwd "
                    f"{library_ms:.5f}; a second launch bit-identical "
                    f"[{card}]")
            del q, k, v, dout, out, lse, delta, dq, dk, dv, ref
    log("[bwd] detail " + json.dumps({"flash_fwd": fwd_rows,
                                      "backward": rows}))
    picked = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        main = next(r for r in rows if r["kernel"] == name
                    and r["dtype"] == "bfloat16" and r["case"] == "train")
        picked[name] = {"max_abs_err": worst[name], **_pick(main),
                        "tflops": main["tflops"],
                        "bound_share": main["bound_share"]}
    main = next(r for r in fwd_rows if r["dtype"] == "bfloat16")
    picked["flash_fwd"] = {"max_abs_err": worst["flash_fwd"], "B": main["B"],
                           "S": main["S"], **_pick(main),
                           "tflops": main["tflops"],
                           "bound_share": main["bound_share"]}
    return picked


def _train_spec(**over):
    from sparkflow_tpu_torch.models import build_registry_spec
    return build_registry_spec("transformer_lm",
                               **dict(GPT2_SMALL, dropout=0.1, **over))


def phase_training(card):
    """``Trainer.fit`` at GPT-2-small width through the attention kernels,
    forward and backward; then one more step under the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparkflow_tpu_torch.core import make_loss_fn, make_train_step
    from sparkflow_tpu_torch.ops import (flash_attention, flash_bwd_dkv,
                                         flash_bwd_dq, reset_launch_counts)
    from sparkflow_tpu_torch.trainer import Trainer
    rows, seq, batch = 64, 1024, 8
    toks = np.random.default_rng(0).integers(0, 1000, (rows, seq)).astype(
        np.float32)
    marks, losses = [], []

    def on_step(loss, it, partition):
        # the trainer has read the epoch's loss back to the host: its one
        # step is done
        marks.append(time.perf_counter())
        losses.append(loss)

    # one step per epoch (a batch of 8 rows drawn from the 64), so the
    # reference's per-epoch loss_callback times each step
    tr = Trainer(_train_spec(), "input_ids", None, optimizer="adam",
                 learning_rate=3e-4, iters=TRAIN_STEPS, mini_batch_size=batch,
                 mini_stochastic_iters=1, compute_dtype="bfloat16", seed=0,
                 loss_callback=on_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.fit(toks)
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches}
    steps = len(losses)
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    want = tr.model.num_layers * TRAIN_STEPS
    if steps != TRAIN_STEPS or any(n != want for n in launches.values()):
        raise AssertionError(f"{steps} steps, launches {launches}; each "
                             f"kernel must launch {want} times")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite, or not falling")
    steady = step_ms[1:]
    summary = {"steps": steps, "batch": batch, "seq": seq,
               "losses": losses,
               "step_ms": step_ms,
               "first_step_includes": "fit set-up (init, staging, optimizer "
                                      "state)",
               "step_ms_median_after_first": sorted(steady)[len(steady) // 2],
               "tokens_per_s_after_first": batch * seq * len(steady)
               / (sum(steady) / 1e3),
               "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
    log("[training] " + json.dumps(summary))

    # one more step, profiled: the trainer's own step function on its
    # parameters and optimizer state
    model = tr.model
    params = model.load_params(tr.params, trainable=True)
    step = make_train_step(make_loss_fn(model, "input_ids", None),
                           tr.optimizer)
    x = torch.as_tensor(toks[:batch], device="cuda")
    y = torch.zeros(batch, 1, device="cuda")
    m = torch.ones(batch, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = tr._last_opt_state
    params, state, _ = step(params, state, x, y, m, gen)     # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, loss = step(params, state, x, y, m, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    prof_sum = _device_profile(prof, wall, 1, kernels=(
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    attn = sum(k["ms"] for k in prof_sum["kernels"].values())
    log("[training-profile] " + json.dumps(
        {"train_step": prof_sum, "attention_kernels_ms": attn,
         "attention_share_of_busy": attn / prof_sum["device_busy_ms"],
         "loss": float(loss), "card": card}))
    return launches


def phase_train_exactness(card):
    """Float32, TF32 off, full width cut to 2 layers: the training step
    through the kernels against the same step through the plain attention
    (autograd of ``attention_reference``), dropout draws shared."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.core import make_train_step
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.optimizers import build_optimizer, tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model_from_json(_train_spec(num_layers=2))
    init = {ln: {pn: t.detach().clone() for pn, t in layer.items()}
            for ln, layer in model.init(seed=2).items()}
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, GPT2_SMALL["vocab_size"], (4, 1024)), device="cuda")

    def fresh():
        return model.load_params({ln: {pn: t.clone() for pn, t in l.items()}
                                  for ln, l in init.items()}, trainable=True)

    def loss_fn(attention):
        return lambda p, xb, y, m, g: model.loss_vector(
            p, {"input_ids": xb}, True, g, attention=attention).mean()

    grads = {}
    for name, att in (("kernel", None), ("plain", attention_reference)):
        p = fresh()
        loss = loss_fn(att)(p, x, None, None,
                            torch.Generator(device="cuda").manual_seed(4))
        grads[name] = (float(loss.detach()),
                       torch.autograd.grad(loss, tree_leaves(p)))
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        raise AssertionError(f"loss {lk} through the kernels, {lp} plain")
    ratio = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(gk, gp))
    if not ratio <= 1e-4:
        raise AssertionError(f"gradients differ by {ratio} x max |plain|")
    traj = {}
    for name, att in (("kernel", None), ("plain", attention_reference)):
        p, opt = fresh(), build_optimizer("adam", 3e-4)
        state, gen = opt.init(p), torch.Generator(device="cuda").manual_seed(5)
        step = make_train_step(loss_fn(att), opt)
        traj[name] = []
        for _ in range(3):
            p, state, loss = step(p, state, x, None, None, gen)
            traj[name].append(float(loss))
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"],
                                                  traj["plain"]))
    if not rel <= 1e-4:
        raise AssertionError(f"adam losses {traj}: differ by {rel} relative")
    log(f"[train-exactness] float32, 2 layers, B=4 S=1024: loss {lk:.7f} vs "
        f"plain {lp:.7f}; max |dgrad| / max |grad| {ratio:.3g} over "
        f"{len(gk)} leaves; 3 adam steps {traj['kernel']} vs "
        f"{traj['plain']} (max rel {rel:.3g}) [{card}]")


# BASELINE.md's transformer configuration, examples/bert_classifier.py at
# full width: BERT-base as a transformer_classifier, float32 (the estimator
# builds its Trainer with no compute dtype)
BERT_BASE = dict(vocab_size=30522, num_classes=2, hidden=768, num_layers=12,
                 num_heads=12, mlp_dim=3072, max_len=512, dropout=0.1)
EST_ROWS, EST_BATCH = 256, 32
# the fitted model's transform against a forward through the plain attention
# on the same weights: float32 (TF32 off), 12 layers; probs absolute, logits
# relative to max(1, their largest magnitude)
EST_PROBS_TOL = 1e-4


def synthetic_text(spark, n, seq_len, vocab):
    """``examples/bert_classifier.py``'s ``synthetic_text`` (copied: that
    example imports the JAX package): token ids with a "positive" marker
    pattern, ragged real lengths, the attention mask as its own column."""
    import numpy as np
    from sparkflow_tpu_torch.localml import Vectors
    rs = np.random.RandomState(0)
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        ids = rs.randint(10, vocab, seq_len)
        if label:
            ids[:: 7] = 3
        n_real = rs.randint(seq_len // 2, seq_len + 1)
        mask = np.zeros(seq_len)
        mask[:n_real] = 1.0
        ids[n_real:] = 0
        rows.append((float(label), Vectors.dense(ids.astype(float)),
                     Vectors.dense(mask)))
    return spark.createDataFrame(rows, ["label", "tokens", "mask"])


def _estimator_reference_model(card, tmp):
    """The reference suite's ``create_model`` on overlapping Gaussians
    (tests/test_estimator.py) through ``SparkAsyncDL`` on the card, in a
    ``Pipeline`` that is saved and loaded."""
    import numpy as np
    import sparkflow_tpu_torch.nn as nn
    from sparkflow_tpu_torch.graph_utils import build_graph
    from sparkflow_tpu_torch.localml import (LocalSession, Pipeline,
                                             PipelineModel, Vectors)
    from sparkflow_tpu_torch.pipeline_util import PysparkPipelineWrapper
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

    def create_model():
        x = nn.placeholder([None, 2], name="x")
        y = nn.placeholder([None, 1], name="y")
        layer1 = nn.dense(x, 12, activation="relu")
        layer2 = nn.dense(layer1, 5, activation="relu")
        out = nn.dense(layer2, 1, activation="sigmoid", name="outer")
        nn.sigmoid_cross_entropy(y, out)

    spark = LocalSession.builder.appName("chip-smoke").getOrCreate()
    rs = np.random.RandomState(12345)
    rows = []
    for _ in range(200):
        rows.append((1.0, Vectors.dense(rs.normal(2, 1, 2))))
        rows.append((0.0, Vectors.dense(rs.normal(-2, 1, 2))))
    df = spark.createDataFrame(rows, ["label", "features"])
    est = SparkAsyncDL(inputCol="features", tensorflowGraph=build_graph(
        create_model), tfInput="x:0", tfLabel="y:0",
        tfOutput="outer/Sigmoid:0", tfOptimizer="adam", tfLearningRate=.1,
        iters=35, partitions=2, predictionCol="predicted", labelCol="label")
    t0 = time.perf_counter()
    fitted = Pipeline(stages=[est]).fit(df)
    fit_s = time.perf_counter() - t0
    if fitted.stages[-1].getDevice() is not None:
        raise AssertionError("the fitted model left the card")
    preds = [r["predicted"] for r in fitted.transform(df).collect()]
    errors = sum(1 for p, r in zip(preds, df.collect())
                 if round(p) != r["label"])
    if not errors < 400:       # the reference's "better than all-wrong"
        raise AssertionError(f"{errors} errors in 400 rows")
    path = os.path.join(tmp, "pipeline")
    fitted.write().overwrite().save(path)
    loaded = PysparkPipelineWrapper.unwrap(PipelineModel.load(path))
    again = [r["predicted"] for r in loaded.transform(df).collect()]
    if again != preds:
        raise AssertionError("the loaded pipeline predicts otherwise")
    log(f"[estimator] nn create_model on the reference's Gaussians: fit "
        f"{fit_s:.2f} s (35 epochs x 4 batches), {errors} errors in 400 "
        f"(reference bar < 400); pipeline saved and loaded, predictions "
        f"identical [{card}]")


def _estimator_kernel_rows(card, masks):
    """Kernels 1-3 against their plain versions at the estimator's shape —
    float32, B=32, H=12, S=512, D=64, non-causal, the masks of the fit's
    first batch — with their times, bounds and SDPA's."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import (attention_reference, flash_attention,
                                         flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference)
    b, s = masks.shape
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, dout = _training_operands(b, s, torch.float32, g)
    out, lse = flash_attention(q, k, v, kv_mask=masks, return_lse=True)
    ref, ref_lse = attention_reference(q, k, v, kv_mask=masks,
                                       return_lse=True)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    args = (q, k, v, dout, lse, delta, False)
    dq = flash_bwd_dq(*args, kv_mask=masks)
    dk, dv = flash_bwd_dkv(*args, kv_mask=masks)
    rdq = flash_bwd_dq_reference(*args, None, masks)
    rdk, rdv = flash_bwd_dkv_reference(*args, None, masks)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max_err(out, ref),
            "flash_bwd_dq": max_err(dq, rdq),
            "flash_bwd_dkv": max(max_err(dk, rdk), max_err(dv, rdv))}
    tops = {"flash_fwd": 1.0, "flash_bwd_dq": float(rdq.abs().max()),
            "flash_bwd_dkv": float(torch.maximum(rdk.abs().max(),
                                                 rdv.abs().max()))}
    lse_err = max_err(lse, ref_lse)
    if not (errs["flash_fwd"] < FLASH_TOL["float32"]
            and lse_err < LSE_TOL["float32"]):
        raise AssertionError(f"flash_fwd at the estimator's shape: max |dO| "
                             f"{errs['flash_fwd']}, max |dlse| {lse_err}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if not errs[name] <= BWD_TOL["float32"] * tops[name]:
            raise AssertionError(f"{name} at the estimator's shape: max |d| "
                                 f"{errs[name]} > {BWD_TOL['float32']} x "
                                 f"{tops[name]}")
    del ref, ref_lse, rdq, rdk, rdv
    # the (query, key) pairs this data needs: every query against the
    # unpadded keys of its row
    pairs = 12 * s * float(masks.sum())
    plane = q.numel() * 4
    stats = b * 12 * s * 4                     # one [B,H,S] float32
    mbytes = masks.numel() * 4
    attn_mask = (masks > 0)[:, None, None, :]
    sdpa_fwd = time_device([lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask)] * 10)
    sdpa_bwd = time_sdpa_backward(q, k, v, dout, masks, False)
    rows = {}
    for name, kern, plain, nbytes, products, lib in (
            ("flash_fwd",
             lambda: flash_attention(q, k, v, kv_mask=masks, return_lse=True),
             lambda: attention_reference(q, k, v, kv_mask=masks,
                                         return_lse=True),
             4 * plane + stats + mbytes, 2, sdpa_fwd),
            ("flash_bwd_dq", lambda: flash_bwd_dq(*args, kv_mask=masks),
             lambda: flash_bwd_dq_reference(*args, None, masks),
             5 * plane + 2 * stats + mbytes, 3, sdpa_bwd),
            ("flash_bwd_dkv", lambda: flash_bwd_dkv(*args, kv_mask=masks),
             lambda: flash_bwd_dkv_reference(*args, None, masks),
             6 * plane + 2 * stats + mbytes, 4, sdpa_bwd)):
        row = {"dtype": "float32", "B": b, "S": s, "causal": False,
               "max_abs_err": errs[name], "ms": time_device([kern] * 10),
               "plain_ms": time_device([plain] * 2), "library_ms": lib,
               "bytes": nbytes, "flops": products * 2 * 64 * pairs}
        _rate(row, "float32")
        rows[name] = row
        log(f"[estimator] {name} float32 B={b} H=12 S={s} D=64 padded keys: "
            f"err {row['max_abs_err']:.3g} ms {row['ms']:.5f} plain "
            f"{row['plain_ms']:.4f} bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}{_cuda_core_note(row)}) "
            f"{row['tflops']:.1f} TFLOP/s, "
            f"{row['bound_share']:.3f} of the bound; sdpa"
            f"{'' if name == 'flash_fwd' else '-bwd'} {lib:.5f} [{card}]")
    return rows


def phase_estimator(card, work):
    """The Spark ML estimator on the card: the reference's own nn model,
    then ``examples/bert_classifier.py`` at BERT-base width through
    ``Pipeline([OneHotEncoder, SparkAsyncDL]).fit`` and ``transform``; the
    probs against a plain-attention forward; kernels 1-3 at its shape.
    The fitted weights stay in ``work`` for the predict phase; returns the
    kernel rows and the fitted ``(modelJson, modelWeights)``."""
    import tempfile
    import numpy as np
    import torch
    import sparkflow_tpu_torch.core as core
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline)
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.convert import list_to_params
    from sparkflow_tpu_torch.ops import (attention_reference, launch_counts,
                                         reset_launch_counts)
    from sparkflow_tpu_torch.tensorflow_async import (SparkAsyncDL,
                                                      SparkAsyncDLModel)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    with tempfile.TemporaryDirectory() as tmp:
        _estimator_reference_model(card, tmp)

        spark = LocalSession.builder.appName("bert-classifier").getOrCreate()
        seq, vocab = BERT_BASE["max_len"], BERT_BASE["vocab_size"]
        df = synthetic_text(spark, EST_ROWS, seq, vocab)
        spec = build_registry_spec("transformer_classifier", **BERT_BASE)
        losses = []
        est = SparkAsyncDL(
            inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
            tfLabel="y:0", tfOutput="pred:0", tfOptimizer="adam",
            tfLearningRate=3e-4, iters=1, miniBatchSize=EST_BATCH,
            labelCol="labels", predictionCol="predicted",
            extraInputCols="mask", extraTfInputs="attention_mask:0",
            weightsPath=os.path.join(work, "bert"))
        est.setLossCallback(lambda loss, it, part: losses.append(loss))
        pipe = Pipeline(stages=[
            OneHotEncoder(inputCol="label", outputCol="labels",
                          dropLast=False), est])
        # a CUDA event after every optimizer step (recorded on the stream,
        # no host sync): the steps after the first on the card's timeline
        marks = []
        make_step = core.make_train_step

        def marked_train_step(loss_fn, optimizer):
            step = make_step(loss_fn, optimizer)

            def marked(*a):
                out = step(*a)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
                return out
            return marked

        core.make_train_step = marked_train_step
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            fitted = pipe.fit(df)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            core.make_train_step = make_step
        fit_launches = {n: launch_counts()[n] for n in names}
        fit_peak = torch.cuda.max_memory_allocated() / 1e9
        steps = len(marks)
        want_steps = -(-EST_ROWS // EST_BATCH)
        if steps != want_steps or any(
                fit_launches[n] != 12 * want_steps for n in names):
            raise AssertionError(f"{steps} steps, launches {fit_launches}; "
                                 f"each kernel must launch 12 x "
                                 f"{want_steps} times")
        if not (losses and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"per-epoch losses {losses}: not finite")
        after_first_s = marks[0].elapsed_time(marks[-1]) / 1e3

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t1 = time.perf_counter()
        preds = fitted.transform(df).collect()
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t1
        tr_launches = {n: launch_counts()[n] for n in names}
        tr_peak = torch.cuda.max_memory_allocated() / 1e9
        parts = df.rdd.getNumPartitions()
        if tr_launches != {"flash_fwd": 12 * parts, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}:
            raise AssertionError(f"transform launches {tr_launches}; want "
                                 f"12 x {parts} partitions of flash_fwd")
        if len(preds) != EST_ROWS or not all(
                r["predicted"] in (0.0, 1.0) for r in preds):
            raise AssertionError("transform: a row without a class")
        acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
        summary = {
            "config": "transformer_classifier BERT-base (768/12/12/3072, "
                      "vocab 30522, max_len 512), float32, adam 3e-4",
            "rows": EST_ROWS, "seq": seq, "batch": EST_BATCH, "steps": steps,
            "fit_s": fit_s,
            "train_examples_per_s_after_first":
                EST_BATCH * (steps - 1) / after_first_s,
            "steps_after_first_s": after_first_s,
            "transform_s": transform_s,
            "transform_examples_per_s": EST_ROWS / transform_s,
            "partitions": parts, "losses": losses, "train_accuracy": acc,
            "peak_mem_gb": {"fit": fit_peak, "transform": tr_peak},
            "launches": {"fit": fit_launches, "transform": tr_launches},
            "card": card}
        log("[estimator] " + json.dumps(summary))

        # the fitted weights through the plain attention on 8 rows: the
        # probs, and the logits, which the fitted model's near-certain
        # probs would not show a difference in
        model_stage = fitted.stages[-1]
        weights = model_stage.getOrDefault(model_stage.modelWeights)
        few = synthetic_text(spark, 8, seq, vocab)
        from sparkflow_tpu_torch.models import model_from_json
        model = model_from_json(spec)
        params = list_to_params(model, resolve_weights(weights))
        rows = few.collect()
        feeds = {"input_ids": torch.tensor(np.stack(
                     [r["tokens"].toArray() for r in rows]), device="cuda"),
                 "attention_mask": torch.tensor(np.stack(
                     [r["mask"].toArray() for r in rows]),
                     dtype=torch.float32, device="cuda")}
        with torch.inference_mode():
            want = model.apply(params, feeds, ["probs", "logits"],
                               attention=attention_reference)
        errs = {}
        for out in ("probs", "logits"):
            stage = SparkAsyncDLModel(
                inputCol="tokens", modelJson=spec, modelWeights=weights,
                tfInput="input_ids:0", tfOutput=out + ":0",
                predictionCol=out, extraInputCols="mask",
                extraTfInputs="attention_mask:0")
            got = np.stack([r[out].toArray()
                            for r in stage.transform(few).collect()])
            ref = want[out].cpu().numpy()
            tol = EST_PROBS_TOL * max(1.0, float(np.abs(ref).max()))
            errs[out] = float(np.abs(got - ref).max())
            if not (errs[out] <= tol and np.isfinite(got).all()):
                raise AssertionError(f"transform {out} differ from the plain "
                                     f"attention's by {errs[out]} (tol "
                                     f"{tol})")
        log(f"[estimator] transform (8 rows) vs plain attention on the same "
            f"weights, float32, TF32 off: probs max |d| {errs['probs']:.3g} "
            f"(tol {EST_PROBS_TOL}), logits max |d| {errs['logits']:.3g} "
            f"(tol {EST_PROBS_TOL} x max(1, max |logit|)) [{card}]")

        # one more training step of the fitted model under the profiler:
        # the estimator's step (float32, dropout 0.1, adam) on its first
        # batch
        first = df.collect()[:EST_BATCH]
        x = tuple(torch.tensor(np.stack([r[c].toArray() for r in first]),
                               dtype=torch.float32, device="cuda")
                  for c in ("tokens", "mask"))
        y = torch.tensor(np.eye(2)[[int(r["label"]) for r in first]],
                         dtype=torch.float32, device="cuda")
        m = torch.ones(EST_BATCH, device="cuda")
        ptree = model.load_params(params, trainable=True)
        from sparkflow_tpu_torch.optimizers import build_optimizer
        opt = build_optimizer("adam", 3e-4)
        state = opt.init(ptree)
        step = core.make_train_step(core.make_loss_fn(
            model, ["input_ids", "attention_mask"], "y"), opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ptree, state, _ = step(ptree, state, x, y, m, gen)      # warm
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ptree, state, loss = step(ptree, state, x, y, m, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t2) * 1e3
        prof_sum = _device_profile(prof, wall, 1, kernels=names)
        attn = sum(k["ms"] for k in prof_sum["kernels"].values())
        log("[estimator-profile] " + json.dumps(
            {"train_step": prof_sum, "attention_kernels_ms": attn,
             "attention_share_of_busy": attn / prof_sum["device_busy_ms"],
             "loss": float(loss), "card": card}))
        del model, params, ptree, state, fitted, pipe, est
        masks = torch.tensor(np.stack([r["mask"].toArray() for r in first]),
                             dtype=torch.float32, device="cuda")
    rows = _estimator_kernel_rows(card, masks)
    return (spec, weights), {n: {"launches": fit_launches[n],
                "transform_launches": tr_launches[n], **_pick(rows[n]),
                "bound_cuda_core_ms": rows[n]["bound_cuda_core_ms"],
                "max_abs_err": rows[n]["max_abs_err"],
                "tflops": rows[n]["tflops"],
                "bound_share": rows[n]["bound_share"]} for n in names}


# phase 13: README's "Serve it online" path at BERT-base, on phase 12's
# fitted weights: four arms, 8 client threads x 8 requests of 1-8 rows
PREDICT_MAX_BATCH = 32
PREDICT_CLIENTS, PREDICT_PER_CLIENT = 8, 8
PREDICT_ARMS = (("a", "float32", {}),
                ("b", "bfloat16", {"compute_dtype": "bfloat16"}),
                ("c", "weight_only", {"quantize": "weight_only"}),
                ("d", "dynamic", {"quantize": "dynamic"}))
# limits, absolute, per arm: "cpu" the card's probs against the same arm
# on the CPU port engine over PREDICT_CPU_ROWS rows of the burst, "logits"
# the same for logits over max(1, max |logit|), "replay" each served answer
# against the card engine's own predict of the burst's rows outside the
# server (other bucket mixes). Each is about 10x its reading on an H100
# 80GB HBM3 (700 W), but no probs limit is under 2e-7: float32 steps by
# 6e-8 just below 1.0, where these probs sit (readings: replay 3.8e-10 to
# 7.6e-10; cpu
# 2.3e-9 / 1.2e-6 / 1.7e-9 / 2.7e-7; logits 6.7e-7 / 2.4e-4 / 4.5e-7 /
# 1.5e-4 in (a) to (d))
PREDICT_TOL = {"a": {"cpu": 2e-7, "logits": 5e-6, "replay": 2e-7},
               "b": {"cpu": 1e-5, "logits": 2e-3, "replay": 2e-7},
               "c": {"cpu": 2e-7, "logits": 5e-6, "replay": 2e-7},
               "d": {"cpu": 3e-6, "logits": 1.5e-3, "replay": 2e-7}}
PREDICT_CPU_ROWS = 16
PREDICT_IN = ["input_ids:0", "attention_mask:0"]


def _predict_rows(n, seed):
    """``n`` rows of phase 12's ``synthetic_text`` kind: token ids with the
    marker pattern on about half, masks ragged over 256-512 live tokens."""
    import numpy as np
    rs = np.random.RandomState(seed)
    seq, vocab = BERT_BASE["max_len"], BERT_BASE["vocab_size"]
    ids = rs.randint(10, vocab, (n, seq))
    mask = np.zeros((n, seq), np.float32)
    for i in range(n):
        if rs.randint(0, 2):
            ids[i, ::7] = 3
        live = rs.randint(seq // 2, seq + 1)
        mask[i, :live] = 1.0
        ids[i, live:] = 0
    return ids.astype(np.int32), mask


def _predict_burst(eng, seed):
    """8 concurrent ``ServingClient.predict`` threads x 8 requests of 1-8
    rows through ``InferenceServer(max_delay_ms=2.0)``; the launch counters
    are zeroed just before and read just after."""
    import numpy as np
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.serving import InferenceServer, ServingClient
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 9, (PREDICT_CLIENTS, PREDICT_PER_CLIENT))
    reqs = [[_predict_rows(int(n), seed * 1000 + 10 * c + j)
             for j, n in enumerate(row)] for c, row in enumerate(sizes)]
    lat, results, errors = [], {}, []
    srv = InferenceServer(eng, max_delay_ms=2.0, memory_watch=False).start()
    try:
        def client(c):
            try:
                cli = ServingClient(srv.url, timeout=600)
                for j, (ids, mask) in enumerate(reqs[c]):
                    t = time.perf_counter()
                    out = cli.predict({"input_ids": ids,
                                       "attention_mask": mask})
                    lat.append((time.perf_counter() - t) * 1e3)
                    results[(c, j)] = np.asarray(out, np.float64)
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        calls0 = eng.metrics.histograms().get(
            "serving/engine_batch_rows", {}).get("count", 0)
        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        if errors:
            raise errors[0]
        hist = ServingClient(srv.url).metrics()["histograms"]
        health = ServingClient(srv.url).healthz()
    finally:
        srv.stop()
    calls = hist["serving/engine_batch_rows"]["count"] - calls0
    for (c, j), out in results.items():
        n = reqs[c][j][0].shape[0]
        if out.shape != (n, 2) or not np.isfinite(out).all() or \
                np.abs(out.sum(-1) - 1.0).max() > 1e-3:
            raise AssertionError(f"request {c}/{j}: probs {out}")
    if len(results) != PREDICT_CLIENTS * PREDICT_PER_CLIENT:
        raise AssertionError(f"{len(results)} answers")
    layers = BERT_BASE["num_layers"]
    others = {k: v for k, v in launches.items() if k != "flash_fwd"}
    if launches["flash_fwd"] != layers * calls or any(others.values()):
        raise AssertionError(f"{calls} bucket calls, launches {launches}: "
                             f"want flash_fwd {layers} a call and no other")
    rows = int(sizes.sum())
    # the burst's rows and answers in request order, for the checks
    keys = sorted(results)
    served = (tuple(np.concatenate([reqs[c][j][i] for c, j in keys])
                    for i in range(2)),
              np.concatenate([results[k] for k in keys]))
    return served, {"requests": len(results), "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "bucket_calls": calls,
            "request_ms_p50": _pct(lat, 50), "request_ms_p95": _pct(lat, 95),
            "server_request_ms": {k: hist["serving/request_latency_ms"][k]
                                  for k in ("p50", "p95", "p99")},
            "batch_rows_mean": hist["serving/engine_batch_rows"]["mean"],
            "padding_waste_mean": hist["serving/padding_waste"]["mean"],
            "healthz_status": health["status"],
            "launches": launches}


def _bucket_ms(eng, bucket, reps=5):
    """ms of one eager bucket call (CUDA events around ``_apply``, inputs
    copied in as a request's are), median of ``reps`` after a warm call."""
    import torch
    xs = _predict_rows(bucket, 7)
    params = eng._snapshot_params()
    times = []
    for i in range(reps + 1):
        a, b = _events()
        a.record()
        eng._apply(params, xs)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def _bucket_profile(eng):
    """``torch.profiler`` over one full-bucket call (32 rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    xs = _predict_rows(PREDICT_MAX_BATCH, 8)
    params = eng._snapshot_params()
    eng._apply(params, xs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._apply(params, xs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return _device_profile(prof, wall, 1, kernels=("flash_fwd",))


def _predict_flash_row(card):
    """``flash_fwd`` at the largest predict bucket in bf16: B=32, H=12,
    S=512, D=64, non-causal, a ragged key mask; against the plain version,
    beside its bound and SDPA's time."""
    import torch
    import torch.nn.functional as F
    from sparkflow_tpu_torch.ops import attention_reference, flash_attention
    b, s = PREDICT_MAX_BATCH, BERT_BASE["max_len"]
    masks = torch.tensor(_predict_rows(b, 3)[1], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(b, 12, s, 64, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = flash_attention(q, k, v, kv_mask=masks)
    ref = attention_reference(q, k, v, kv_mask=masks)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if not err < FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash_fwd bf16 at the predict bucket: max "
                             f"|dO| {err}")
    attn_mask = (masks > 0)[:, None, None, :]
    pairs = 12 * s * float(masks.sum())
    # the bytes this data needs: Q and O whole; K and V of each batch row
    # up to its last live key, as ``pairs`` counts only live keys
    live = masks > 0
    last = torch.where(live.any(-1), s - live.flip(-1).int().argmax(-1), 0)
    kv_bytes = 2 * 12 * 64 * q.element_size() * float(last.sum())
    row = {"dtype": "bfloat16", "B": b, "S": s, "causal": False,
           "max_abs_err": err,
           "ms": time_device([lambda: flash_attention(q, k, v,
                                                      kv_mask=masks)] * 10),
           "plain_ms": time_device([lambda: attention_reference(
               q, k, v, kv_mask=masks)] * 2),
           "library_ms": time_device([lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=attn_mask)] * 10),
           "bytes": 2 * q.numel() * q.element_size() + kv_bytes
                    + masks.numel() * 4,
           "flops": 2 * 2 * 64 * pairs}
    _rate(row, "bfloat16")
    log(f"[predict] flash_fwd bf16 B={b} H=12 S={s} D=64 padded keys: err "
        f"{err:.3g} ms {row['ms']:.5f} plain {row['plain_ms']:.4f} sdpa "
        f"{row['library_ms']:.5f} bound {row['bound_ms']:.5f} "
        f"({row['bound_by']}) {row['tflops']:.1f} TFLOP/s, "
        f"{row['bound_share']:.3f} of the bound [{card}]")
    return row


def _arm_outputs(eng, xs):
    """probs and logits of the rows ``xs`` through ``eng``'s model and
    serving params, on its device, as float64 numpy."""
    import numpy as np
    import torch
    feeds = {k: torch.as_tensor(a, device=eng.device)
             for k, a in zip(eng._in_keys, xs)}
    with torch.inference_mode():
        out = eng.model.apply(eng._snapshot_params(), feeds,
                              ["probs", "logits"], train=False)
    return {k: v.float().cpu().numpy().astype(np.float64)
            for k, v in out.items()}


def _predict_checks(tag, eng, spec, weights, kw, extra, rows, served):
    """One arm's answers held to ``PREDICT_TOL[tag]``: every served answer
    against the card engine's own predict of the same rows (a row sent
    back to the wrong request, or a padding row leaking into a real one,
    shows there; the rows must not all win the same class, so a mix-up
    cannot hide); a seeded sample of ``PREDICT_CPU_ROWS`` burst rows
    against the same arm on the CPU port engine, probs and logits; an int8
    arm's ``q8``/``scale`` built on the card bit-equal to the CPU's."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.serving import InferenceEngine
    tol = PREDICT_TOL[tag]
    replay = eng.predict(rows)
    r_err = float(np.abs(served - replay).max())
    wins = np.bincount(replay.argmax(-1), minlength=2)
    pick = np.sort(np.random.default_rng(ord(tag)).choice(
        len(served), PREDICT_CPU_ROWS, replace=False))
    sample = tuple(a[pick] for a in rows)
    t0 = time.perf_counter()
    cpu = InferenceEngine(spec, weights, device="cpu", warmup=False,
                          **dict(kw, max_batch=2), **extra)
    got, want = _arm_outputs(eng, sample), _arm_outputs(cpu, sample)
    cpu_s = time.perf_counter() - t0
    p_err = float(np.abs(got["probs"] - want["probs"]).max())
    top = max(1.0, float(np.abs(want["logits"]).max()))
    l_err = float(np.abs(got["logits"] - want["logits"]).max()) / top
    errs = {"replay_max_abs_err": r_err, "replay_wins": wins.tolist(),
            "cpu_rows": PREDICT_CPU_ROWS, "cpu_check_s": cpu_s,
            "cpu_probs_max_abs_err": p_err,
            "cpu_logits_max_abs_err_over_top": l_err, "logits_top": top}
    log(f"[predict] arm ({tag}) checks: " + json.dumps(errs))
    if not (r_err < tol["replay"] and wins.min() > 0
            and np.isfinite(served).all()):
        raise AssertionError(f"arm ({tag}): served answers vs the engine's "
                             f"replay max |d| {r_err} (tol {tol['replay']}), "
                             f"wins per class {wins.tolist()}")
    if not (p_err < tol["cpu"] and l_err < tol["logits"]
            and np.isfinite(got["logits"]).all()):
        raise AssertionError(f"arm ({tag}): card vs CPU probs max |d| "
                             f"{p_err} (tol {tol['cpu']}), logits max |d| / "
                             f"{top} {l_err} (tol {tol['logits']})")
    if "quantize" in extra:
        for ln, layer in eng._snapshot_params().items():
            for pn, t in layer.items():
                if not torch.equal(t.cpu(), cpu._params[ln][pn]):
                    raise AssertionError(f"arm ({tag}): {ln}/{pn} built on "
                                         f"the card differs from the CPU's")
    return errs


def phase_predict(card, spec, weights, work):
    """The predict plane on the card: ``InferenceEngine(modelJson,
    modelWeights)`` -> ``InferenceServer`` -> ``ServingClient.predict`` in
    four arms on phase 12's fitted BERT-base; each arm's answers against
    its own replay and the CPU port engine (``_predict_checks``), arm (a)
    against the plain attention; then a port
    ``Trainer(publish_to=)`` and a ``WeightWatcher`` swap."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.ml_util import resolve_weights
    from sparkflow_tpu_torch.ops import attention_reference
    from sparkflow_tpu_torch.serving import (InferenceEngine, WeightStore,
                                             WeightWatcher)
    from sparkflow_tpu_torch.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(input_name=PREDICT_IN, output_name="probs:0",
              max_batch=PREDICT_MAX_BATCH)
    arms, launches, eng_a = {}, {}, None
    for tag, name, extra in PREDICT_ARMS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngine(spec, weights, **kw, **extra)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        (rows, served), burst = _predict_burst(eng, seed=ord(tag))
        launches[tag] = burst["launches"]["flash_fwd"]
        buckets = {b: _bucket_ms(eng, b) for b in (1, 8, PREDICT_MAX_BATCH)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _bucket_profile(eng)
        errs = _predict_checks(tag, eng, spec, weights, kw, extra, rows,
                               served)
        summary = {"arm": tag, "serving": name, "engine_build_s": build_s,
                   **burst, "bucket_ms": buckets, "peak_mem_gb": peak,
                   **errs, "tol": PREDICT_TOL[tag],
                   "bucket32_profile": prof, "stats": eng.stats(),
                   "card": card}
        log("[predict] " + json.dumps(summary))
        arms[tag] = summary
        if tag == "a":
            eng_a = eng
        else:
            del eng
    torch.cuda.empty_cache()

    # arm (a) against a forward through the plain attention, TF32 off
    rows = _predict_rows(8, 5)
    got = eng_a.predict(rows)
    feeds = {"input_ids": torch.tensor(rows[0], device="cuda"),
             "attention_mask": torch.tensor(rows[1], device="cuda")}
    with torch.inference_mode():
        ref = eng_a.model.apply(eng_a._snapshot_params(), feeds,
                                ["probs", "logits"],
                                attention=attention_reference)
        mine = eng_a.model.apply(eng_a._snapshot_params(), feeds,
                                 ["logits"])["logits"]
    p_err = float(np.abs(got - ref["probs"].cpu().numpy()).max())
    top = max(1.0, float(ref["logits"].abs().max()))
    l_err = float((mine - ref["logits"]).abs().max())
    if not (p_err < EST_PROBS_TOL and l_err < EST_PROBS_TOL * top):
        raise AssertionError(f"arm (a) vs plain attention: probs {p_err}, "
                             f"logits {l_err} (tol {EST_PROBS_TOL} x {top})")
    log(f"[predict] arm (a) vs plain attention (8 rows, float32, TF32 off): "
        f"probs max |d| {p_err:.3g}, logits max |d| {l_err:.3g} (tol "
        f"{EST_PROBS_TOL} x max(1, max |logit|)) [{card}]")

    # live publication: a port Trainer publishes, the watcher swaps arm (a)
    store = WeightStore(os.path.join(work, "store"))
    w = resolve_weights(weights)
    specs = eng_a.model.param_specs()
    it = iter(w)
    init = {ln: {pn: next(it) for pn in ps} for ln, ps in specs.items()}
    ids, mask = _predict_rows(2 * EST_BATCH, 11)
    labels = np.eye(2, dtype=np.float32)[np.random.RandomState(12).randint(
        0, 2, 2 * EST_BATCH)]
    tr = Trainer(spec, ["input_ids", "attention_mask"], "y",
                 optimizer="adam", learning_rate=3e-4, iters=1,
                 mini_batch_size=EST_BATCH, shuffle_per_iter=False,
                 publish_to=store)
    t0 = time.perf_counter()
    res = tr.fit((ids.astype(np.float32), mask), labels, init_params=init)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if store.all_versions() != [1] or not all(
            math.isfinite(x) for x in res.losses):
        raise AssertionError(f"published {store.all_versions()}, losses "
                             f"{res.losses}")
    del tr, res
    before = eng_a.predict(rows)
    watcher = WeightWatcher(store, [eng_a])
    if not watcher.poll_once() or eng_a.serving_version() != 1:
        raise AssertionError(f"watcher did not swap: {watcher.stats()}")
    version, tree = store.load(like=eng_a.weights_template())
    fresh = InferenceEngine(spec, tree, **kw)
    after, want = eng_a.predict(rows), fresh.predict(rows)
    if not np.array_equal(after, want):
        raise AssertionError(f"swapped engine vs fresh engine on version "
                             f"{version}: max |d| "
                             f"{np.abs(after - want).max()}")
    moved = float(np.abs(after - before).max())
    log("[predict-publish] " + json.dumps(
        {"trainer_steps": 2, "train_s": train_s,
         "versions": store.all_versions(), "served_version":
         eng_a.serving_version(), "watcher": watcher.stats(),
         "probs_moved_by_swap": moved,
         "swapped_equals_fresh_engine": True, "card": card}))
    del eng_a, fresh
    torch.cuda.empty_cache()
    row = _predict_flash_row(card)
    return {"launches": launches, "bf16_B32_S512": {
        **_pick(row), "max_abs_err": row["max_abs_err"],
        "tflops": row["tflops"], "bound_share": row["bound_share"]}}


# phase 14: resilience and stream — README's text pipeline at BERT-base width
# through the estimator's stream mode with checkpoints, Trainer.fit preempted,
# crashed and resumed, one fit traced, and remat="dots" at the training shape
# (c) runs 2 epochs: with 3 the phase took over the ~90 s it is allowed
RES_ROWS, RES_BATCH, RES_EPOCHS = 256, 32, 2
RES_LEN = BERT_BASE["max_len"]
RES_SAMPLE = 32           # rows whose native ids are held to the fallback's
# the resumed weights equal the uninterrupted fit's bit for bit (no kernel
# uses atomics); this relative bound is a fallback that is never used
# silently: a run that needs it prints its delta
RESUME_REL_TOL = 1e-6
SPAN_TOL = 0.10           # phase sums against the fit's host wall time


def synthetic_reviews(n, seed):
    """Long reviews in the shape of ``examples/text_classifier.py``'s
    ``synthetic_reviews`` (filler words, a sentiment marker inserted), 200
    to 700 words each: the filler from a seeded 20,000-word pseudo-lexicon
    drawn by a Zipf law, every twelfth word carrying punctuation, the
    marker inserted three times. Returns ``[(label, text)]``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    pos = ["wonderful", "great", "loved", "excellent", "delightful"]
    neg = ["terrible", "awful", "hated", "boring", "dreadful"]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lexicon = np.array(["".join(rs.choice(letters, rs.randint(2, 10)))
                        for _ in range(20000)])
    p = 1.0 / np.arange(1, len(lexicon) + 1)
    p /= p.sum()
    rows = []
    for _ in range(n):
        label = rs.randint(0, 2)
        k = rs.randint(200, 701)
        words = list(lexicon[rs.choice(len(lexicon), k, p=p)])
        for j in rs.choice(k, k // 12, replace=False):
            words[j] += ",.!?"[rs.randint(4)]
        for _ in range(3):
            words.insert(rs.randint(0, len(words)),
                         (pos if label else neg)[rs.randint(0, 5)])
        rows.append((float(label), " ".join(words)))
    return rows


def _text_front(card, texts):
    """(a) The vocabulary over the corpus, the native tokenizer's ids and
    masks against the pure-Python fallback's on a sample, encode rates."""
    import numpy as np
    from sparkflow_tpu_torch.native.build import load_library
    from sparkflow_tpu_torch.utils.text import WordpieceTokenizer, build_vocab
    t0 = time.perf_counter()
    vocab = build_vocab(texts)
    vocab_s = time.perf_counter() - t0
    native = load_library() is not None
    if not native:
        raise AssertionError("the native data-plane library did not build "
                             "or load (g++): the C++ path is the one "
                             "measured")
    tok, plain = (WordpieceTokenizer(vocab),
                  WordpieceTokenizer(vocab, use_native=False))
    t0 = time.perf_counter()
    ids, mask = tok.encode_batch(texts, RES_LEN)
    native_s = time.perf_counter() - t0
    sample = texts[:RES_SAMPLE]
    t0 = time.perf_counter()
    pids, pmask = plain.encode_batch(sample, RES_LEN)
    plain_s = time.perf_counter() - t0
    if not (np.array_equal(ids[:RES_SAMPLE], pids)
            and np.array_equal(mask[:RES_SAMPLE], pmask)):
        raise AssertionError("native WordPiece ids or masks differ from the "
                             "pure-Python fallback's")
    live = mask.sum(1)
    info = {"native_library_loaded": native, "vocab": len(vocab),
            "vocab_s": vocab_s, "rows": len(texts), "max_len": RES_LEN,
            "truncated_rows": int((live == RES_LEN).sum()),
            "live_tokens_min_median": [int(live.min()),
                                       int(np.median(live))],
            "unk_share": float((ids == tok.unk_id).sum() / live.sum()),
            "encode_rows_per_s_native": len(texts) / native_s,
            "encode_rows_per_s_fallback": RES_SAMPLE / plain_s,
            "native_equals_fallback_rows": RES_SAMPLE, "card": card}
    log("[resilience-text] " + json.dumps(info))
    return vocab, info


class _SaveClock:
    """Times every ``CheckpointManager.save`` while active (host ms, the
    state's copy off the card included) and reads each save's bytes from
    its manifest."""

    def __init__(self):
        self.saves = []

    def __enter__(self):
        from sparkflow_tpu_torch import checkpoint as ckpt
        self._cls, self._orig = ckpt.CheckpointManager, \
            ckpt.CheckpointManager.save
        orig, saves = self._orig, self.saves

        def save(mgr, step, state):
            t0 = time.perf_counter()
            orig(mgr, step, state)
            ms = (time.perf_counter() - t0) * 1e3
            files = (mgr._manifest(step) or {}).get("files", {})
            saves.append({"step": int(step), "ms": ms,
                          "bytes": sum(f["bytes"] for f in files.values())})

        self._cls.save = save
        return self

    def __exit__(self, *exc):
        self._cls.save = self._orig
        return False


def _stream_fit(card, rows, vocab, spec, work):
    """(b) ``Pipeline([WordpieceEncoder, OneHotEncoder, SparkAsyncDL(
    fitMode="stream", checkpointDir, checkpointEvery=4)])`` over the corpus,
    then its transform."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.checkpoint import CheckpointManager
    from sparkflow_tpu_torch.localml import (LocalSession, OneHotEncoder,
                                             Pipeline, WordpieceEncoder)
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    spark = LocalSession.builder.appName("text-stream").getOrCreate()
    df = spark.createDataFrame(rows, ["label", "text"])
    ck = os.path.join(work, "stream-ckpt")
    marks = []
    est = SparkAsyncDL(
        inputCol="tokens", tensorflowGraph=spec, tfInput="input_ids:0",
        tfLabel="y:0", tfOutput="pred:0", tfOptimizer="adam",
        tfLearningRate=3e-4, iters=1, miniBatchSize=RES_BATCH,
        labelCol="labels", predictionCol="predicted", fitMode="stream",
        checkpointDir=ck, checkpointEvery=4, extraInputCols="mask",
        extraTfInputs="attention_mask:0",
        # an npz side file: inline, 110 M weights would be ~2 GB of JSON
        weightsPath=os.path.join(work, "text-bert"))
    est.setLossCallback(
        lambda loss, step, part: marks.append((time.perf_counter(), loss)))
    pipe = Pipeline(stages=[
        WordpieceEncoder(inputCol="text", outputCol="tokens", maskCol="mask",
                         maxLen=RES_LEN, vocab=vocab),
        OneHotEncoder(inputCol="label", outputCol="labels", dropLast=False),
        est])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _SaveClock() as clock:
        fitted = pipe.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: launch_counts()[n] for n in names}
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = RES_ROWS // RES_BATCH
    losses = [loss for _t, loss in marks]
    if len(marks) != steps or any(launches[n] != 12 * steps for n in names):
        raise AssertionError(f"{len(marks)} steps, launches {launches}: each "
                             f"flash kernel must launch 12 x {steps} times")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stream losses {losses}: not finite")
    mgr = CheckpointManager(ck)
    if mgr.all_steps() != [4, 8] or not all(
            mgr.verify_step(s) is True for s in (4, 8)):
        raise AssertionError(f"stream checkpoints {mgr.all_steps()}: steps "
                             f"4 and 8 must verify by their manifests")
    saves = clock.saves
    if [s["step"] for s in saves] != [4, 8]:
        raise AssertionError(f"saves {saves}")
    span = marks[-1][0] - marks[0][0]                   # steps 2 .. 8
    in_span = sum(s["ms"] for s in saves if s["step"] < steps) / 1e3
    t1 = time.perf_counter()
    preds = fitted.transform(df).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t1
    acc = float(np.mean([r["predicted"] == r["label"] for r in preds]))
    info = {"rows": RES_ROWS, "batch": RES_BATCH, "steps": steps,
            "fit_s": fit_s, "losses": losses,
            "train_examples_per_s_steps_2_to_8": RES_BATCH * (steps - 1)
            / span,
            "train_examples_per_s_steps_2_to_8_without_saves":
                RES_BATCH * (steps - 1) / (span - in_span),
            "saves": saves, "launches": launches, "peak_mem_gb": peak,
            "transform_s": transform_s, "train_accuracy": acc,
            "card": card}
    log("[resilience-stream] " + json.dumps(info))
    shutil.rmtree(ck, ignore_errors=True)
    return info


def _resume_delta(tr, base_weights):
    """``(bit_equal, max |a - b| / max |b|)`` of a trainer's final weights
    against the uninterrupted fit's."""
    import numpy as np
    got = tr.weights_list()
    same = all(np.array_equal(a, b) for a, b in zip(got, base_weights))
    rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-30)
              for a, b in zip(got, base_weights))
    return same, rel


def _preempt_and_resume(card, x, labels, spec, work):
    """(c) ``Trainer.fit`` (collect) over the encoded rows, 2 epochs of 8
    steps, ``checkpoint_every=1``: an uninterrupted fit, traced (d); a fit
    preempted in epoch 1 (the guard is read at each epoch's start, so a
    SIGTERM in the last epoch would not stop it) and fitted again; a fit
    crashed in epoch 2 and resumed in the fit."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.resilience import faults
    from sparkflow_tpu_torch.trainer import Trainer
    from sparkflow_tpu_torch.utils.flops import device_peak_flops

    def trainer(name, cb, retries=0):
        return Trainer(spec, ["input_ids", "attention_mask"], "y",
                       optimizer="adam", learning_rate=3e-4,
                       iters=RES_EPOCHS, mini_batch_size=RES_BATCH, seed=14,
                       checkpoint_dir=os.path.join(work, name),
                       checkpoint_every=1, resume_retries=retries,
                       loss_callback=cb)

    out = {}
    base = trainer("base", lambda *a: None)
    trace = os.path.join(work, "fit_trace.json")
    with _SaveClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = base.fit(x, labels, trace_spans=trace)
        wall = time.perf_counter() - t0
    want = base.weights_list()
    stats = base.last_step_stats
    with open(base.last_trace_path) as f:
        events = json.load(f)["traceEvents"]
    phases = stats["phase_totals_s"]
    spent = sum(phases.values())
    if not (res.completed and abs(spent - wall) <= SPAN_TOL * wall
            and events):
        raise AssertionError(f"traced fit: phases sum {spent} s against "
                             f"{wall} s of wall time, {len(events)} trace "
                             f"events")
    ck_ms = [s["ms"] for s in clock.saves]
    out["uninterrupted"] = {
        "epochs": RES_EPOCHS, "steps": RES_EPOCHS * RES_ROWS // RES_BATCH,
        "losses": res.losses, "fit_wall_s": wall,
        "phase_totals_s": phases, "phase_counts": stats["phase_counts"],
        "phase_sum_over_wall": spent / wall,
        "checkpoint_share_of_wall": phases.get("checkpoint", 0.0) / wall,
        "save_ms": ck_ms, "save_bytes": [s["bytes"] for s in clock.saves],
        "examples_per_s": stats["examples_per_sec"],
        "flops_per_step": stats.get("flops_per_step"),
        "flops_per_s": stats.get("flops_per_sec"),
        "mfu": stats.get("mfu"), "mfu_peak_flops": device_peak_flops(),
        "mfu_note": "against the dense bf16 peak (the JAX package's "
                    "convention); the step runs float32 with TF32 off",
        "trace_events": len(events)}
    shutil.rmtree(os.path.join(work, "base"), ignore_errors=True)
    del base

    tr = trainer("preempt", faults.sigterm_at(1))
    first = tr.fit(x, labels)
    again = tr.fit(x, labels)
    if first.stop_reason != "preempted" or not again.completed:
        raise AssertionError(f"preempted fit: {first.stop_reason}, then "
                             f"{again.stop_reason}")
    same, rel = _resume_delta(tr, want)
    out["preempted"] = {"stop_reason": first.stop_reason,
                        "epochs_before": len(first.losses),
                        "epochs_after": len(again.losses),
                        "weights_bit_equal": same, "max_rel_delta": rel}
    shutil.rmtree(os.path.join(work, "preempt"), ignore_errors=True)
    del tr

    crash = faults.crash_at(2)
    tr = trainer("crash", crash, retries=1)
    res = tr.fit(x, labels)
    if crash.fired != 1 or not res.completed:
        raise AssertionError(f"crashed fit: fired {crash.fired}, "
                             f"{res.stop_reason}")
    same_c, rel_c = _resume_delta(tr, want)
    out["crashed"] = {"fault_fired": crash.fired, "completed": res.completed,
                      "weights_bit_equal": same_c, "max_rel_delta": rel_c}
    shutil.rmtree(os.path.join(work, "crash"), ignore_errors=True)
    del tr
    out["card"] = card
    log("[resilience-resume] " + json.dumps(out))
    for k in ("preempted", "crashed"):
        if not (out[k]["weights_bit_equal"]
                or out[k]["max_rel_delta"] <= RESUME_REL_TOL):
            raise AssertionError(f"{k} fit resumed to weights {out[k]} away "
                                 f"from the uninterrupted fit's")
    return out


def _remat_modes(card):
    """(e) One training step (forward and backward) of the GPT-2-small-width
    bf16 ``transformer_lm`` at batch 8 x 1024, dropout 0.1, in each
    ``remat`` mode: peak memory above the step's start, step ms (CUDA
    events), flash_fwd launches, then one more step's device busy time
    under the profiler; "dots" and "full" against False."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.ops import launch_counts, reset_launch_counts
    from sparkflow_tpu_torch.optimizers import tree_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1000, (8, 1024)), device="cuda")
    out, ref = {}, None
    for remat in (False, "dots", "full"):
        model = model_from_json(_train_spec(remat=remat), "bfloat16")
        params = model.load_params(tree_map(
            lambda a: a.detach().clone(), model.init(seed=0)), trainable=True)
        leaves = tree_leaves(params)
        gen = torch.Generator(device="cuda")

        def step():
            gen.manual_seed(1)
            loss = model.loss_vector(params, {"input_ids": toks}, train=True,
                                     generator=gen).mean()
            return loss, torch.autograd.grad(loss, leaves)

        step()                                                   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launch_counts()
        a, b = _events()
        a.record()
        loss, grads = step()
        b.record()
        b.synchronize()
        row = {"step_ms": a.elapsed_time(b),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "peak_above_start_gb": (torch.cuda.max_memory_allocated()
                                       - start) / 1e9,
               "flash_fwd_launches": launch_counts()["flash_fwd"],
               "flash_bwd_launches": launch_counts()["flash_bwd_dq"],
               "loss": float(loss)}
        # one more step under the profiler: the card's busy time against
        # the host's (the selective policy runs Python for every op)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        prof_sum = _device_profile(prof, wall, 1)
        row.update(profiled_wall_ms=prof_sum["wall_ms"],
                   device_busy_ms=prof_sum["device_busy_ms"],
                   device_idle_share=prof_sum["device_idle_share"],
                   device_ops=prof_sum["device_ops"])
        grads = [g.float().cpu() for g in grads]
        if ref is None:
            ref = (float(loss), grads)
        else:
            errs = [float((g - r).abs().max()) / max(float(r.abs().max()),
                                                     1e-30)
                    for g, r in zip(grads, ref[1])]
            row["loss_delta"] = abs(float(loss) - ref[0])
            row["max_grad_err_over_max_grad"] = max(errs)
            row["bit_equal_to_no_remat"] = (
                row["loss_delta"] == 0 and max(errs) == 0)
            if not (row["loss_delta"] <= BWD_TOL["bfloat16"] * abs(ref[0])
                    and max(errs) <= BWD_TOL["bfloat16"]):
                raise AssertionError(f"remat={remat!r} against remat=False: "
                                     f"{row}")
        out[str(remat)] = row
        del model, params, leaves, grads, loss
        torch.cuda.empty_cache()
    want = {"False": 12, "dots": 24, "full": 24}
    got = {k: out[k]["flash_fwd_launches"] for k in want}
    peaks = [out[k]["peak_above_start_gb"] for k in ("full", "dots", "False")]
    out["card"] = card
    log("[resilience-remat] " + json.dumps(out))
    if got != want or not peaks[0] < peaks[1] < peaks[2]:
        raise AssertionError(f"flash_fwd launches {got} (want {want}); peak "
                             f"memory full / dots / False {peaks} must "
                             f"rise in that order")
    return got


def phase_resilience(card, work):
    """Phase 14: (a) the text front, (b) the stream fit through the
    estimator with checkpoints, (c) preempted and crashed fits resumed, (d)
    the traced fit's spans and MFU, (e) ``remat="dots"``. Returns the
    launch counts for the kernels line."""
    import numpy as np
    import torch
    from sparkflow_tpu_torch.models import build_registry_spec
    from sparkflow_tpu_torch.utils.text import WordpieceTokenizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = synthetic_reviews(RES_ROWS, seed=14)
    texts = [t for _l, t in rows]
    vocab, _text = _text_front(card, texts)
    spec = build_registry_spec("transformer_classifier", **BERT_BASE)
    stream = _stream_fit(card, rows, vocab, spec, work)
    ids, mask = WordpieceTokenizer(vocab).encode_batch(texts, RES_LEN)
    labels = np.eye(2, dtype=np.float32)[[int(l) for l, _t in rows]]
    resume = _preempt_and_resume(card, (ids.astype(np.float32), mask),
                                 labels, spec, work)
    remat = _remat_modes(card)
    return {"stream_fit": stream["launches"],
            "uninterrupted_fit_steps": resume["uninterrupted"]["steps"],
            "remat_flash_fwd_per_step": remat}


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
    t0 = time.perf_counter()
    # phase 12's fitted weights and phase 13's weight store
    work = tempfile.mkdtemp(prefix="chip-smoke-")

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {name} {time.perf_counter() - t:.1f} s")
        return out

    try:
        timed("setup", phase_setup)
        flash_row, paged_row = timed("kernels", phase_kernels, card)
        spec_rows = timed("spec-kernels", phase_spec_kernels, card)
        bwd_rows = timed("bwd", phase_backward_kernels, card)
        launches, eng = timed("serving", phase_serving, card)
        timed("profile", phase_profile, card, eng)
        del eng
        spec_launches = timed("spec-serving", phase_spec_serving, card)
        timed("exactness", phase_exactness, card)
        timed("spec-exactness", phase_spec_exactness, card)
        train_launches = timed("training", phase_training, card)
        timed("train-exactness", phase_train_exactness, card)
        (spec, weights), est_rows = timed("estimator", phase_estimator,
                                          card, work)
        predict = timed("predict", phase_predict, card, spec, weights, work)
        resil = timed("resilience", phase_resilience, card, work)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[time] all phases {time.perf_counter() - t0:.1f} s")
    src = "sparkflow_tpu_torch/ops/csrc/"
    ref = "sparkflow_tpu/ops/attention.py:"
    spec_a, spec_b = spec_launches["a"], spec_launches["b"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
         "replaces": ref + "196",
         "launches": launches["flash_fwd"], **flash_row,
         # the same kernel on the training path: its launches there and its
         # times at the training shape
         "training": {"launches": train_launches["flash_fwd"],
                      **bwd_rows["flash_fwd"]},
         "spec_serving": {"launches": [spec_a["flash_fwd"],
                                       spec_b["flash_fwd"]]},
         # the estimator phase: BERT-base fit (launches) and transform,
         # times at its shape (float32, B=32, S=512, padded keys)
         "estimator": est_rows["flash_fwd"],
         # the predict phase: launches per arm (a) float32, (b) bf16,
         # (c) weight_only, (d) dynamic; times at its largest bucket, bf16
         "predict": predict,
         # phase 14: the BERT-base stream fit's launches, and a step's at
         # GPT-2-small width in each remat mode
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_fwd"],
                        "remat_launches_per_step":
                        resil["remat_flash_fwd_per_step"]}},
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu", "replaces": ref + "734",
         "launches": launches["paged_attention"], **paged_row,
         # the self-speculation draft chain of burst (a), bf16 pool
         "spec_serving": {"launches": spec_a["paged_attention"]}},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "372",
         "launches": train_launches["flash_bwd_dq"],
         **bwd_rows["flash_bwd_dq"], "estimator": est_rows["flash_bwd_dq"],
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_bwd_dq"]}},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": src + "flash_bwd.cu", "replaces": ref + "415",
         "launches": train_launches["flash_bwd_dkv"],
         **bwd_rows["flash_bwd_dkv"],
         "estimator": est_rows["flash_bwd_dkv"],
         "resilience": {"stream_fit_launches":
                        resil["stream_fit"]["flash_bwd_dkv"]}},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": src + "paged_attention.cu", "replaces": ref + "781",
         "launches": spec_b["paged_attention_quant"],
         **spec_rows["paged_attention_quant"]},
        {"name": "paged_verify", "route": "cuda",
         "source": src + "paged_verify.cu", "replaces": ref + "967",
         "launches": spec_a["paged_verify"], **spec_rows["paged_verify"]},
        {"name": "paged_verify_quant", "route": "cuda",
         "source": src + "paged_verify.cu", "replaces": ref + "1015",
         "launches": spec_b["paged_verify_quant"],
         **spec_rows["paged_verify_quant"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
