"""Online serving: train with the estimator, serve over HTTP with
micro-batching — the port of the JAX package's
``examples/serving_example.py``.

The full path from a fitted estimator to a live endpoint:

1. ``SparkAsyncDL.fit`` trains as usual; the fitted model's
   ``modelWeights`` Param is the wire-format weights string.
2. ``InferenceEngine`` loads (graph JSON, weights) onto the H100 and runs
   every batch-size bucket of its ladder once at warmup, so no request
   size meets a new shape afterwards.
3. ``InferenceServer`` exposes ``/v1/predict`` (micro-batched: concurrent
   requests coalesce into one device call), ``/healthz`` and ``/metrics``.
4. ``ServingClient`` hits the endpoint from a pool of threads, then reads
   the serving histograms (batch fill, latency p50/p95/p99) back from
   ``/metrics``.

    python -m sparkflow_tpu_torch.examples.serving_example [--device cpu] [--smoke]
"""

import threading

import numpy as np

from sparkflow_tpu_torch import nn
from sparkflow_tpu_torch.compat import USING_PYSPARK
from sparkflow_tpu_torch.examples import _common
from sparkflow_tpu_torch.graph_utils import build_graph
from sparkflow_tpu_torch.tensorflow_async import SparkAsyncDL

if USING_PYSPARK:
    from pyspark.ml.linalg import Vectors
else:
    from sparkflow_tpu_torch.localml import Vectors


def model():
    x = nn.placeholder([None, 16], name='x')
    y = nn.placeholder([None, 1], name='y')
    h = nn.dense(x, 64, activation='relu')
    out = nn.dense(h, 1, activation='sigmoid', name='outer')
    nn.sigmoid_cross_entropy(y, out)


def run(*, device="cuda", smoke=False, workdir=None, rows=None, iters=None,
        clients=None):
    """Fit, serve and query; returns ``accuracy`` over the clients'
    answers, ``latency_ms`` (p50 / p95 / p99), ``batch_fill``,
    ``recompiles`` after warmup, the fit's ``losses`` and ``fit_s``, and
    ``requests_per_s`` over the burst."""
    from sparkflow_tpu_torch.serving import (InferenceEngine,
                                             InferenceServer, ServingClient)
    device = _common.check_device(device)
    _common.workdir(workdir)
    spark = _common.session('serving-example')
    rs = np.random.RandomState(0)
    rows_ = []
    for _ in range(rows or (100 if smoke else 400)):
        rows_.append((1.0, Vectors.dense(rs.normal(0.8, 1.0, 16))))
        rows_.append((0.0, Vectors.dense(rs.normal(-0.8, 1.0, 16))))
    df = spark.createDataFrame(rows_, ['label', 'features'])

    iters = iters or (3 if smoke else 15)
    est = SparkAsyncDL(
        inputCol='features', tensorflowGraph=build_graph(model),
        tfInput='x:0', tfLabel='y:0', tfOutput='outer/Sigmoid:0',
        labelCol='label', tfLearningRate=.05, iters=iters,
        miniBatchSize=128, verbose=0, device=device)
    log = _common.LossLog()
    est.setLossCallback(log)
    fitted, fit_s = _common.timed(lambda: est.fit(df))

    # fitted Params -> engine: same graph JSON, same weights wire format
    engine = InferenceEngine(
        fitted.getOrDefault(fitted.modelJson),
        fitted.getOrDefault(fitted.modelWeights),
        input_name='x:0', output_name='outer/Sigmoid:0', max_batch=32,
        device=device)
    print(f'engine ready: buckets={engine.buckets} '
          f'aot_compiles={engine.aot_compiles}')

    with InferenceServer(engine, max_delay_ms=2.0) as server:
        client = ServingClient(server.url)
        print(f'serving at {server.url}  healthz={client.healthz()["status"]}')

        n_clients = clients or (4 if smoke else 16)
        hits, lock = [], threading.Lock()

        def one_client(i):
            x = rs.normal(0.8 if i % 2 else -0.8, 1.0, (3, 16))
            pred = client.predict(x)
            correct = np.mean((pred[:, 0] > 0.5) == bool(i % 2))
            with lock:
                hits.append(correct)

        threads = [threading.Thread(target=one_client, args=(i,))
                   for i in range(n_clients)]

        def burst():
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        _, burst_s = _common.timed(burst)
        print(f'{n_clients} concurrent clients served, '
              f'accuracy={np.mean(hits):.3f}')

        m = client.metrics()
        lat = m['histograms']['serving/request_latency_ms']
        fill = m['histograms']['serving/batch_fill_ratio']
        print(f"latency ms p50={lat['p50']:.2f} p95={lat['p95']:.2f} "
              f"p99={lat['p99']:.2f}; mean batch fill={fill['mean']:.3f}")
        print(f'recompiles after warmup: {engine.fallback_compiles}')
    return {"accuracy": float(np.mean(hits)), "answers": len(hits),
            "latency_ms": {k: lat[k] for k in ("p50", "p95", "p99")},
            "batch_fill": fill["mean"],
            "recompiles": engine.fallback_compiles, "losses": log.losses,
            "fit_s": fit_s, "requests_per_s": n_clients / burst_s}


def main(argv=None):
    a = _common.parser(__doc__).parse_args(argv)
    run(device=a.device, smoke=a.smoke, workdir=a.workdir)


if __name__ == '__main__':
    main()
