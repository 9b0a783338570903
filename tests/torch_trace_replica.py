"""Subprocess replica for the port's flight-recorder harvest test
(``tests/test_torch_tracing.py``); imports the port and nothing of JAX.

Run as ``python tests/torch_trace_replica.py --port N --flight-dir D
[--predict-delay-s S]``: the port's :class:`InferenceServer` over a trivial
echo engine, flight recorder armed, SIGTERM drain handlers installed.
``--predict-delay-s`` makes every predict sleep, so the parent test can
SIGKILL the process with a request (and its flight ``begin`` line) in
flight.
"""

import argparse
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--flight-dir", required=True)
    parser.add_argument("--predict-delay-s", type=float, default=0.0)
    ns = parser.parse_args()

    import numpy as np

    from sparkflow_tpu_torch.resilience.lifecycle import ServerState
    from sparkflow_tpu_torch.serving import InferenceServer

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sparkflow_tpu"))
    if loaded:
        raise SystemExit(f"the port's replica imported {loaded}")

    class EchoEngine:
        max_batch = 8

        def __init__(self, delay_s: float):
            self.delay_s = delay_s

        def predict(self, x):
            if self.delay_s:
                time.sleep(self.delay_s)
            return np.asarray(x)

        def stats(self):
            return {}

    server = InferenceServer(EchoEngine(ns.predict_delay_s), port=ns.port,
                             max_delay_ms=0.5, memory_watch=False,
                             flight_dir=ns.flight_dir)
    server.start()
    server.install_signal_handlers()
    print(f"replica up on {server.url}", flush=True)
    while server.lifecycle.state in (ServerState.STARTING,
                                     ServerState.SERVING):
        time.sleep(0.1)
    server.stop()


if __name__ == "__main__":
    main()
