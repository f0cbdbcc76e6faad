"""Model registry: load serialized models once, pin their tensors on the card.

The estimators' decision_function copies sv_X/coef/b from host numpy on
every call: fine for offline scoring, hostile to a serving hot path (a
host-to-device copy of the whole SV set per request). A ModelEntry does
that copy exactly once at load, through the same function the offline
scorer uses (models/svm.py:score_operands), and the bucket cache
(buckets.py) captures its programs over the SAME pinned tensors, so a
steady-state request uploads only its own padded rows.

Feature scaling stays on the host (numpy f64, per batch): it is O(m*d) on
a few-row batch, and keeping it there makes the served scores use the
exact scaler arithmetic of the offline path (the bit-identity contract).

The registry is VERSIONED: every entry carries a generation counter that
`swap()` bumps under the registry lock, `get_versioned()` returns a
consistent (entry, generation) pair, and artifact loads are classified: a
missing, truncated or corrupted .npz raises :class:`ModelLoadError`
(ServeStatus.LOAD_FAILED) naming the path, with transient I/O retried
through faults.DEFAULT_IO_POLICY and the raw bytes routed through the
``registry.load`` injection point (where corrupt rules mangle them)
before parsing.
"""

from __future__ import annotations

import dataclasses
import io
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpusvm_torch.config import SVMConfig
from tpusvm_torch.data.scaler import MinMaxScaler
from tpusvm_torch.device import resolve_device
from tpusvm_torch.status import ServeStatus


class ModelLoadError(Exception):
    """A model artifact could not be loaded or staged
    (ServeStatus.LOAD_FAILED).

    One named error for every way an artifact read goes bad (missing
    file, truncated or corrupted zip, a non-model npz, transient I/O past
    the retry budget), so `serve`, POST /admin/swap and the --watch loop
    report the offending path and cause instead of a raw traceback, and
    a failed hot-swap stage rolls back cleanly."""

    status = ServeStatus.LOAD_FAILED

    def __init__(self, path: str, cause: BaseException):
        self.path = path
        self.cause = cause
        super().__init__(
            f"failed to load model artifact {path!r}: "
            f"{type(cause).__name__}: {cause}"
        )


def _read_model_bytes(path: str) -> bytes:
    """Artifact bytes through the retried ``registry.load`` fault point.

    The read is retried under DEFAULT_IO_POLICY; the returned payload may
    have been corrupted by an active corrupt rule, which np.load's zip CRC
    then catches downstream (the staged-swap failure path)."""
    from tpusvm_torch import faults

    def _read():
        with open(path, "rb") as f:
            raw = f.read()
        # the point carries the bytes: transient/kill/latency rules act
        # like any other I/O fault, corrupt rules mangle the payload
        out = faults.point("registry.load", payload=raw, path=path)
        return out if out is not None else raw

    retry = faults.Retry(faults.DEFAULT_IO_POLICY, op="registry.load")
    return retry(_read)


def _concrete(device) -> torch.device:
    """The device with its index ("cuda" -> "cuda:0"): tensors and the
    approximate map's per-device copies are then keyed alike."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class ModelEntry:
    """One servable model: tensors pinned on the device + host scaler."""

    name: str
    kind: str                      # "binary" | "ovr" | "svr"
    config: SVMConfig
    n_features: int                # RAW request-row width (approximate
    #                                models: the pre-map width; X_sv is mapped)
    X_sv: torch.Tensor             # (n_sv, d) on the device
    coef: torch.Tensor             # binary: (n_sv,) alpha*y; ovr: (n_sv, K);
    #                                svr: (n_sv,) signed alpha - alpha*
    b: torch.Tensor                # binary/svr: scalar; ovr: (K,)
    scaler: Optional[MinMaxScaler]
    classes: Optional[np.ndarray]  # ovr only
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    # Platt sigmoid (A, B) of a calibrated binary classifier; the HTTP
    # frontend then adds a `proba` field computed on the host from the
    # served scores (the exact predict_proba arithmetic)
    platt: Optional[tuple] = None
    # approximate-family models: the fitted FeatureMap, its parameter
    # tensors already on the device (the bucket programs map inside)
    fmap: Optional[object] = None
    # hot-swap provenance: the registry bumps `generation` on every swap
    # (1 = the initially loaded model); `source_path` is the .npz the
    # entry came from (None for in-process add_model), recorded in
    # serve_state.json so a restarted server reloads its model set
    generation: int = 1
    source_path: Optional[str] = None

    @property
    def n_sv(self) -> int:
        return int(self.X_sv.shape[0])

    def scale(self, X: np.ndarray) -> np.ndarray:
        return self.scaler.transform(X) if self.scaler is not None else X

    @classmethod
    def from_estimator(cls, name: str, model, device=None) -> "ModelEntry":
        """Pin an already-fitted BinarySVC / OneVsRestSVC / EpsilonSVR on
        `device` (default: the estimator's) in the estimator's dtype.

        The operands are the ones the estimator's own decision_function
        builds (models/svm.py:score_operands), so every served score is
        that call's bits. SVR pins its signed sv_coef_ (the score IS the
        regressed value); calibrated classifiers carry their Platt
        coefficients for the frontend's proba field."""
        from tpusvm_torch.models.svm import score_operands

        dev = _concrete(model.device if device is None else device)
        fmap = getattr(model, "fmap_", None)
        if fmap is not None:
            # the map's parameters go to the device once, like the SV set
            # (and before any capture: a capture copies nothing from host)
            fmap.device_arrays(dev)

        def nf(sv_arr) -> int:
            # approximate models serve RAW rows (the program maps inside);
            # sv_arr's width is the MAPPED dim there
            return (int(fmap.n_features_in) if fmap is not None
                    else int(np.asarray(sv_arr).shape[1]))

        common = dict(name=name, config=model.config,
                      scaler=model.scaler_ if model.scale else None,
                      dtype=model.dtype, device=dev, fmap=fmap)
        if getattr(model, "classes_", None) is not None:
            if model.X_sv_ is None:
                raise RuntimeError("model is not fitted")
            sv, coef, b = score_operands(model, model.coef_.T, model.b_, dev)
            return cls(kind="ovr", n_features=nf(model.X_sv_), X_sv=sv,
                       coef=coef, b=b, classes=np.asarray(model.classes_),
                       **common)
        if model.sv_X_ is None:
            raise RuntimeError("model is not fitted")
        if getattr(model, "sv_coef_", None) is not None:
            sv, coef, b = score_operands(model, model.sv_coef_, model.b_, dev)
            return cls(kind="svr", n_features=nf(model.sv_X_), X_sv=sv,
                       coef=coef, b=b, classes=None, **common)
        sv, coef, b = score_operands(model, model.sv_alpha_ * model.sv_Y_,
                                     model.b_, dev)
        return cls(kind="binary", n_features=nf(model.sv_X_), X_sv=sv,
                   coef=coef, b=b, classes=None,
                   platt=getattr(model, "platt_", None), **common)

    @classmethod
    def from_path(cls, name: str, path: str, dtype=torch.float32,
                  device="cuda") -> "ModelEntry":
        """Load a serialized model (binary, one-vs-rest or SVR, either
        package's .npz) and pin it on `device` in `dtype`.

        The artifact bytes are read with transient-I/O retries and parsed
        from memory: a corrupt or truncated file, a non-model npz, or
        exhausted retries raise :class:`ModelLoadError` naming the path,
        never a raw BadZipFile/zlib traceback from inside numpy."""
        import zlib
        from zipfile import BadZipFile

        from tpusvm_torch import faults
        from tpusvm_torch.models import load_any

        dev = _concrete(device)
        try:
            raw = _read_model_bytes(path)
            model = load_any(io.BytesIO(raw), device=dev, dtype=dtype)
        except faults.SimulatedKill:
            raise  # a killed process does not get a classification
        except (OSError, ValueError, KeyError, BadZipFile, zlib.error,
                # zipfile raises NotImplementedError when corruption
                # lands on a member's compression-type field
                NotImplementedError, EOFError,
                faults.RetryExhaustedError) as e:
            raise ModelLoadError(path, e) from e
        entry = cls.from_estimator(name, model, device=dev)
        entry.source_path = path
        return entry

    def validate_rows(self, X: np.ndarray) -> np.ndarray:
        # float64 on the host whatever the model dtype: the scaler then
        # runs the offline path's f64 arithmetic, and the cast to the model
        # dtype happens once, at the pad-buffer upload (bit-identity with
        # the estimator's decision_function on the same rows)
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"model {self.name!r} expects rows of {self.n_features} "
                f"features, got array of shape {X.shape}"
            )
        return X

    def describe(self) -> dict:
        """A summary for status endpoints (no device tensors)."""
        d = {
            "name": self.name,
            "kind": self.kind,
            "generation": self.generation,
            "source_path": self.source_path,
            "n_sv": self.n_sv,
            "n_features": self.n_features,
            "kernel": self.config.kernel,
            "gamma": self.config.gamma,
            "C": self.config.C,
            "scaled": self.scaler is not None,
            "calibrated": self.platt is not None,
            "device": str(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
        }
        if self.config.kernel == "poly":
            d["degree"] = self.config.degree
            d["coef0"] = self.config.coef0
        if self.config.kernel == "sigmoid":
            d["coef0"] = self.config.coef0
        if self.fmap is not None:
            # which map the bucket programs run
            d["map_seed"] = self.config.map_seed
            d["map_dim"] = self.fmap.dim
            if self.config.kernel == "nystrom":
                d["landmarks"] = self.config.landmarks
        if self.kind == "svr":
            d["epsilon"] = self.config.epsilon
        if self.classes is not None:
            d["classes"] = [int(c) for c in self.classes]
        return d


class ModelRegistry:
    """Thread-safe, VERSIONED name -> ModelEntry map.

    `add` installs generation 1 (or the entry's own, when a
    serve_state.json restore carries a history forward), `swap` stamps old
    generation + 1 onto the replacement and stores it in ONE lock region,
    so a reader calling `get_versioned` never observes an entry whose
    `.generation` disagrees with the generation the registry reports."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}

    def add(self, entry: ModelEntry) -> ModelEntry:
        with self._lock:
            if entry.name in self._entries:
                raise ValueError(f"model {entry.name!r} already registered")
            self._entries[entry.name] = entry
        return entry

    def swap(self, entry: ModelEntry) -> int:
        """Replace the registered entry of the same name; returns the new
        generation. The name must already be registered."""
        with self._lock:
            old = self._entries.get(entry.name)
            if old is None:
                raise KeyError(
                    f"cannot swap unknown model {entry.name!r}; "
                    f"registered: {sorted(self._entries)}"
                )
            entry.generation = old.generation + 1
            self._entries[entry.name] = entry
            return entry.generation

    def load(self, name: str, path: str, dtype=torch.float32,
             device="cuda") -> ModelEntry:
        return self.add(ModelEntry.from_path(name, path, dtype=dtype,
                                             device=device))

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: "
                    f"{sorted(self._entries)}"
                ) from None

    def get_versioned(self, name: str) -> Tuple[ModelEntry, int]:
        """(entry, generation) read in one lock region."""
        with self._lock:
            try:
                e = self._entries[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: "
                    f"{sorted(self._entries)}"
                ) from None
            return e, e.generation

    def generation(self, name: str) -> int:
        return self.get_versioned(name)[1]

    def unload(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    def names(self):
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries
