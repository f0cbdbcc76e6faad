"""Pod-scale out-of-core cascade: coordinator + worker subprocesses.

The port of tpusvm/pod/. The reference's MPI cascade as a process
transport: a coordinator drives N worker subprocesses over stdlib sockets
(length-prefixed framed messages, pod/protocol.py), each worker being one
cascade LEAF that loads only its manifest shards via stream.ShardReader
and trains with the port's solvers (on the card, kernels #1 and #2 for
blocked leaves, pair_rows for pair leaves). SV sets merge through
parallel.svbuffer.merge_dedup under both reference topologies (binary
tree and star), round after round until the global SV-ID set stabilises
— the same fixed point, bit for bit, as parallel.cascade.cascade_fit,
which stays the in-process parity control.

Because leaves are host processes, they take the shrinking driver the
in-process cascade refuses (solver="blocked" with shrink_every and its
siblings).

Crash safety: the coordinator checkpoints inter-round state through
fsync_replace (pod/state.py, fault point ``pod.merge``), a killed worker
is revived and the in-flight round re-runs from its round-start state
bit-identically (``pod.worker``), and a killed coordinator resumes from
the checkpoint (``pod.round``) — exercised by ``python -m
tpusvm_torch.faults pod-chaos-smoke``.
"""

from tpusvm_torch.pod.coordinator import PodResult, pod_fit

__all__ = ["PodResult", "pod_fit"]
