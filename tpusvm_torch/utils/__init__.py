"""Host utilities: the durable commit, the run logger, phase timing and
the profiler hook."""
from tpusvm_torch.utils.durable import fsync_replace
from tpusvm_torch.utils.logging import RunLogger
from tpusvm_torch.utils.timing import PhaseTimer, trace

__all__ = ["PhaseTimer", "RunLogger", "fsync_replace", "trace"]
