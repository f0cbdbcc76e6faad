"""`serve --watch DIR`: poll a directory, hot-swap newer models.

The port's copy of tpusvm/serve/watch.py (host only). `refresh --save
dir/model.npz` (or `train --save`) drops an artifact atomically (save_model
writes a temp file + os.replace, so a watcher never sees a half-written
file), and the serving process picks it up on its next poll:

  * a .npz whose stem is NOT yet hosted is loaded and warmed as a new
    model under that name;
  * a .npz whose stem IS hosted and whose mtime advanced is hot-swapped
    (Server.swap: staged off to the side, probe-verified, atomic flip; a
    bad artifact rolls back and the old generation keeps serving).

Failures are remembered per (path, mtime): a file that failed to stage
is not retried until its mtime changes again (no hot-looping on a
corrupt artifact), and every outcome lands in the log callback + the
swap metrics the server already keeps.

The poll thread is owned: daemon=True AND stop() joins it. `poll_once()`
is the test surface: deterministic, no thread required.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple


class ModelWatcher:
    """Directory poller driving Server.load_model / Server.swap."""

    def __init__(self, server, watch_dir: str, interval_s: float = 2.0,
                 log_fn: Optional[Callable[[str], None]] = print,
                 warmup: bool = True):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.server = server
        self.watch_dir = watch_dir
        self.interval_s = interval_s
        self.log = log_fn or (lambda msg: None)
        self.warmup = warmup
        # path -> mtime of the last SUCCESSFULLY loaded/swapped version
        self._loaded: Dict[str, float] = {}
        # path -> mtime of the last FAILED version (skip until it moves)
        self._failed: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ polling
    def _scan(self) -> List[Tuple[str, float]]:
        """One os.scandir sweep: name filter + the dirent's own stat (a
        scandir entry carries its stat result from the directory read, so
        the mtime index costs one sweep whatever the entry count)."""
        out = []
        try:
            with os.scandir(self.watch_dir) as it:
                for entry in it:
                    if not entry.name.endswith(".npz"):
                        continue
                    try:
                        if not entry.is_file():
                            continue
                        out.append((entry.path, entry.stat().st_mtime))
                    except OSError:
                        continue  # deleted between readdir and stat
        except OSError:
            return []  # watch dir missing/unreadable this tick
        out.sort()
        return out

    def poll_once(self) -> List[dict]:
        """One poll pass; returns the actions taken:
        [{"name", "path", "action": "loaded"|"swapped"|"failed",
          "error"?}]."""
        actions = []
        for path, mtime in self._scan():
            if self._loaded.get(path) == mtime \
                    or self._failed.get(path) == mtime:
                continue
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                if name in self.server.registry:
                    out = self.server.swap(name, path)
                    action = {"name": name, "path": path,
                              "action": "swapped",
                              "generation": out["generation"]}
                    self.log(f"watch: swapped {name} -> generation "
                             f"{out['generation']} ({path})")
                else:
                    self.server.load_model(name, path)
                    if self.warmup:
                        self.server.warmup(name)
                    action = {"name": name, "path": path,
                              "action": "loaded"}
                    self.log(f"watch: loaded new model {name} ({path})")
                self._loaded[path] = mtime
                self._failed.pop(path, None)
            except Exception as e:  # noqa: BLE001 — a bad artifact must
                # not kill the watch loop; the server already rolled back
                self._failed[path] = mtime
                action = {"name": name, "path": path, "action": "failed",
                          "error": f"{type(e).__name__}: {e}"}
                self.log(f"watch: FAILED {name} ({path}): "
                         f"{type(e).__name__}: {e} — previous "
                         "generation keeps serving")
            actions.append(action)
        return actions

    # ------------------------------------------------------------ thread
    def start(self) -> "ModelWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — keep polling
                    self.log(f"watch: poll error: "
                             f"{type(e).__name__}: {e}")

        # tpusvm: guarded-by=owner-only lifecycle; start/stop run on the owning thread, the poll thread never touches _thread
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="tpusvm-torch-serve-watch")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            # tpusvm: guarded-by=owner-only lifecycle; cleared after the joined thread exited
            self._thread = None
