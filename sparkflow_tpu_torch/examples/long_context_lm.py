"""Long-context causal LM with ring-attention sequence parallelism — the
port of the JAX package's ``examples/long_context_lm.py``.

The sequence axis shards over an ``sp`` ring of two ranks: each rank holds
half of every sequence, and K/V blocks travel round the ring, so a rank's
attention memory is O(S / 2). Each rank runs the flash-attention kernels on
its blocks (``ops/attention.py`` ``ring_flash_attention``). The ranks are
processes this example launches (``parallel.distributed.launch``), one
card each where there are two; on one card both share it. The JAX example
forces a virtual 8-device CPU mesh instead; there is no such mesh here.

    python -m sparkflow_tpu_torch.examples.long_context_lm [--device cpu] [--smoke]
"""

import time

import numpy as np

from sparkflow_tpu_torch.examples import _common

SP = 2
VOCAB = 512


def spec_for(smoke, seq):
    from sparkflow_tpu_torch.models import build_registry_spec
    return build_registry_spec(
        "transformer_lm", vocab_size=VOCAB,
        hidden=64 if smoke else 512,
        num_layers=2 if smoke else 8,
        num_heads=4 if smoke else 8,
        mlp_dim=128 if smoke else 2048,
        # 'dots' saves matmul outputs and recomputes only the cheap
        # elementwise ops: far less backward recompute than full remat,
        # still bounded activation memory at long sequence lengths
        max_len=seq, dropout=0.0, remat="dots" if not smoke else False)


def rank_steps(spec, seq, steps, device):
    """One rank's part: ``steps`` adam steps of the sp train step on this
    rank's half of every sequence. Returns the global losses, the seconds
    of the steps after the first, and this rank's kernel launches."""
    import torch
    import torch.distributed as dist

    from sparkflow_tpu_torch import ops
    from sparkflow_tpu_torch.models import model_from_json
    from sparkflow_tpu_torch.optimizers import build_optimizer, tree_map
    from sparkflow_tpu_torch.parallel.distributed import rank_device
    from sparkflow_tpu_torch.parallel.mesh import Mesh
    from sparkflow_tpu_torch.parallel.sp import make_sp_train_step

    dev = rank_device(dist.get_rank(), device)
    mesh = Mesh({"dp": 1, "sp": SP})
    lm = model_from_json(spec, device=dev)
    optimizer = build_optimizer("adam", 3e-4, None)
    params = tree_map(lambda t: t.requires_grad_(True), lm.init(seed=0))
    opt_state = optimizer.init(params)
    rs = np.random.RandomState(0)
    batch = 2
    losses, t1 = [], None
    launches0 = ops.launch_counts()
    with mesh.bind():
        step = make_sp_train_step(lm, optimizer, mesh)
        block = slice(mesh.axis_index("sp") * (seq // SP),
                      (mesh.axis_index("sp") + 1) * (seq // SP))
        for i in range(steps):
            ids = torch.as_tensor(rs.randint(0, VOCAB, (batch, seq))[:, block],
                                  device=dev)
            mask = torch.ones(ids.shape, dtype=torch.float32, device=dev)
            params, opt_state, loss = step(params, opt_state, ids, mask, i)
            losses.append(float(loss))      # reads the loss back: a sync
            if i == 0:
                t1 = time.perf_counter()
    after = ops.launch_counts()
    return {"losses": losses, "steady_s": time.perf_counter() - t1,
            "launches": {k: after[k] - launches0.get(k, 0) for k in after}}


def run(*, device="cuda", smoke=False, workdir=None, seq=None, steps=3):
    """Train ``steps`` steps on two launched sp ranks; returns the
    per-step ``losses``, ``tokens_per_s`` over the steps after the first,
    ``fit_s`` and the ranks' summed kernel ``launches``."""
    from sparkflow_tpu_torch.parallel.distributed import launch
    device = _common.check_device(device)
    _common.workdir(workdir)
    seq = seq or (512 if smoke else 8192)          # global context length
    print(f"mesh: dp=1 x sp={SP}, context length {seq}")
    out, fit_s = _common.timed(lambda: launch(
        rank_steps, SP, spec_for(smoke, seq), seq, steps,
        device.split(":")[0], device=device.split(":")[0]))
    for i, loss in enumerate(out[0]["losses"]):
        print(f"step {i}: loss {loss:.4f}")
    launches = {k: sum(r["launches"][k] for r in out)
                for k in out[0]["launches"]}
    steady = max(r["steady_s"] for r in out)
    return {"losses": out[0]["losses"], "rank_losses": [r["losses"]
                                                        for r in out],
            "tokens_per_s": (2 * seq * (steps - 1) / steady
                             if steps > 1 else float("nan")),
            "fit_s": fit_s, "launches": launches}


def main(argv=None):
    p = _common.parser(__doc__)
    p.add_argument("--seq", type=int, default=None,
                   help="global context length (default 8192, 512 smoke)")
    a = p.parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir, seq=a.seq)


if __name__ == "__main__":
    main()
