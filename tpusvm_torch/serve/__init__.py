"""tpusvm_torch.serve: batched online inference over trained SVM models.

The port of the JAX package's serving tier (tpusvm/serve/): the path from
a serialized model to low-latency predictions under concurrent load, with
the adaptive-batching shape of Clipper (Crankshaw et al., NSDI 2017) over
the repo's own decision function.

  registry.py   load + pin: models come off disk once; their SV, coef and
                b tensors live on the card for the server's lifetime
  batcher.py    deadline-aware micro-batching: single-row requests
                coalesce into batches under a max-latency budget, with a
                bounded queue (fast-fail backpressure) and per-request
                timeouts
  buckets.py    batches pad to power-of-two row buckets, one CUDA graph a
                (model, bucket), captured at warm-up; build counter
  metrics.py    request/error/timeout counters, batch occupancy, latency
                percentiles, SLO burn; JSON + plaintext /metrics dumps
  server.py     the in-process frontend: Server.submit()/submit_many(),
                atomic hot-swap (Server.swap: staged generation flip),
                the per-model circuit breaker
  http.py       stdlib-only JSON-over-HTTP endpoint (`serve`), POST
                /admin/swap
  cache.py      restart robustness: the bucket-signature manifest and the
                serve_state.json registry manifest (the JAX package's
                bytes)
  watch.py      `serve --watch DIR`: poll for newer artifacts, hot-swap
  refresh.py    `refresh`: crash-safe warm-started refits that hot-swap
                into the running registry

Correctness contract: a served score is BIT-IDENTICAL to the estimator's
decision_function on the same rows, whatever the batch size, bucket,
position in the batch, in-process or HTTP delivery, or generation. Every
scorer call runs full `block`-row products (solver/predict.py), so the
offline call and every bucket graph run products of one shape; the host
arithmetic (f64 scaling, the cast at upload) is the offline path's.
"""

from tpusvm_torch.serve.batcher import MicroBatcher, ServeResult
from tpusvm_torch.serve.buckets import CompileCache, bucket_for, default_buckets
from tpusvm_torch.serve.metrics import Metrics, SLOConfig
from tpusvm_torch.serve.registry import ModelEntry, ModelLoadError, ModelRegistry
from tpusvm_torch.serve.server import ServeConfig, Server, SwapError

__all__ = [
    "CompileCache",
    "Metrics",
    "MicroBatcher",
    "ModelEntry",
    "ModelLoadError",
    "ModelRegistry",
    "SLOConfig",
    "ServeConfig",
    "ServeResult",
    "Server",
    "SwapError",
    "bucket_for",
    "default_buckets",
]
