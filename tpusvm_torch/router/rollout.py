"""Generation-skew detection for staggered hot-swap rollouts.

The port's copy of tpusvm/router/rollout.py. A fleet rollout is N
independent /admin/swap flips, one replica at a time. Each replica's
/healthz swap block reports the generation it serves per model, so
"where is the fleet?" is a readable vector:

    generation_vector(snapshot, "m")  ->  {url: gen or None}

and "is the rollout healthy?" a predicate on it: the SKEW (max - min over
replicas that answered) may not exceed the window. window=1 is the steady
staggered state (the replica being swapped runs one generation ahead
until its neighbours catch up); skew 2+ means a replica was left behind
(its swap failed and rolled back while the rollout marched on). On
detection the rollout HOLDS: no further swap is issued, the report names
the laggards, and the router's /healthz carries RouterStatus.SKEW_HOLD.

"All replicas on generation k", a skew-free vector with no unknowns, is
the completion predicate router-chaos-smoke gates on.

The per-replica swap POST is non-idempotent (each success advances the
generation counter) and is therefore NEVER retried: a failed swap is
recorded and the skew check decides whether the rollout may continue.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from tpusvm_torch.router.health import post_json
from tpusvm_torch.status import RouterStatus


def generation_vector(snapshot, model: str) -> Dict[str, Optional[int]]:
    """{url: serving generation of `model`} from a HealthPoller
    snapshot; None for replicas that are down/never-polled or do not
    report the model (both are "unknown", not zero)."""
    out: Dict[str, Optional[int]] = {}
    for url, rec in snapshot.items():
        if rec.state == "down" or rec.polls == 0:
            out[url] = None
        else:
            out[url] = rec.generations.get(model)
    return out


def skew_of(vector: Dict[str, Optional[int]]) -> int:
    """max - min over the KNOWN generations (0 when <= 1 replica
    reports; unknowns are reported separately, not guessed at)."""
    gens = [g for g in vector.values() if g is not None]
    if len(gens) < 2:
        return 0
    return max(gens) - min(gens)


@dataclasses.dataclass
class SkewReport:
    """One skew check's verdict over a model's generation vector."""

    model: str
    vector: Dict[str, Optional[int]]
    skew: int
    window: int
    held: bool                      # skew > window: hold the rollout
    unknown: Tuple[str, ...] = ()   # replicas with no readable generation

    @property
    def laggards(self) -> Tuple[str, ...]:
        """Replicas serving the OLDEST known generation (who to chase)."""
        gens = [g for g in self.vector.values() if g is not None]
        if not gens:
            return ()
        lo = min(gens)
        return tuple(sorted(u for u, g in self.vector.items() if g == lo))

    def to_json(self) -> dict:
        return {
            "model": self.model,
            "vector": dict(sorted(self.vector.items())),
            "skew": self.skew,
            "window": self.window,
            "held": self.held,
            "unknown": list(self.unknown),
            "laggards": list(self.laggards),
        }


def check_skew(snapshot, model: str, window: int = 1) -> SkewReport:
    """Evaluate the skew predicate for `model` over a poller snapshot."""
    if window < 0:
        raise ValueError(f"skew window must be >= 0, got {window}")
    vector = generation_vector(snapshot, model)
    skew = skew_of(vector)
    unknown = tuple(sorted(u for u, g in vector.items() if g is None))
    return SkewReport(model=model, vector=vector, skew=skew,
                      window=window, held=skew > window, unknown=unknown)


def staggered_rollout(poller, model: str, path: str, window: int = 1,
                      post: Callable = post_json,
                      timeout_s: float = 60.0,
                      log_fn: Optional[Callable[[str], None]] = None
                      ) -> dict:
    """Swap `model` to `path` across the fleet, one replica at a time.

    Before EVERY per-replica swap the fleet is re-polled and the skew
    predicate re-checked: skew beyond the window holds the rollout right
    there (status SKEW_HOLD, nothing further issued). Replicas that are
    down or draining are skipped (they restore the new artifact from
    serve_state.json or pick it up on a later rollout — swapping a dead
    replica is not a thing). Each swap POST fires AT MOST ONCE (non-
    idempotent; never retried); a 409 rollback is recorded per replica
    and surfaces as skew on the next check.

    Returns {"status": RouterStatus name, "swapped": [urls], "skipped":
    [urls], "failed": {url: error}, "report": final SkewReport json}.
    """
    log = log_fn or (lambda msg: None)
    poller.poll_once()
    swapped: List[str] = []
    skipped: List[str] = []
    failed: Dict[str, str] = {}
    for url in sorted(poller.snapshot()):
        rep = check_skew(poller.snapshot(), model, window=window)
        if rep.held:
            log(f"router: rollout of {model} HELD at skew {rep.skew} "
                f"(window {window}; laggards {list(rep.laggards)})")
            return {"status": RouterStatus.SKEW_HOLD.name,
                    "swapped": swapped, "skipped": skipped,
                    "failed": failed, "report": rep.to_json()}
        rec = poller.snapshot().get(url)
        if rec is None or rec.state in ("down", "draining"):
            skipped.append(url)
            continue
        code, payload = post(url.rstrip("/") + "/admin/swap",
                             {"name": model, "path": path},
                             timeout_s=timeout_s)
        if code == 200 and payload.get("swapped"):
            swapped.append(url)
            log(f"router: rolled {model} -> generation "
                f"{payload.get('generation')} on {url}")
        else:
            failed[url] = f"HTTP {code}: {payload.get('error', payload)}"
            log(f"router: rollout swap FAILED on {url}: {failed[url]}")
        poller.poll_once()
    final = check_skew(poller.snapshot(), model, window=window)
    if final.held:
        status = RouterStatus.SKEW_HOLD
    else:
        status = RouterStatus.OK
    return {"status": status.name, "swapped": swapped,
            "skipped": skipped, "failed": failed,
            "report": final.to_json()}
