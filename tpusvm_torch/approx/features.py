"""Seeded, deterministic approximate-kernel feature maps: RFF and Nystrom.

The port of tpusvm/approx/features.py. Both maps send the rbf kernel into
an EXPLICIT feature space where K(x, z) ~= Phi(x).Phi(z), so every kernel
touchpoint becomes the linear family's matmul (kernels/dispatch.py routes
the approx names through kernels/linear.py) and the solvers' cost turns
linear in n.

  * rff (Rahimi & Recht, NeurIPS 2007): D/2 Gaussian frequency draws
    omega ~ N(0, 2*gamma*I) give
        Phi(x) = sqrt(2/D) * [cos(x.omega) ; sin(x.omega)].
  * nystrom (Williams & Seeger, NeurIPS 2001): k landmark rows M drawn
    from the data, Phi(x) = K(x, M) @ K(M, M)^{-1/2}, the inverse root's
    eigenvalues floored for stability.

On the host, in numpy: every parameter draw comes from
np.random.default_rng(map_seed), and the Nystrom weights are computed in
f64 and cast once, exactly as the JAX package does, so the same (seed,
shape, gamma) gives the same omega, landmark indices and W bit for bit in
either package.

On the card: the transforms and the mapped decision. The map GEMM runs at
the trust tier through ops/rbf.py:matmul_p (IEEE f32; never single-pass
TF32, which matmul_p refuses): the JAX map runs at Precision.HIGHEST, and
a rounded operand aliases frequencies under cos/sin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpusvm_torch.config import APPROX_FAMILIES, SVMConfig, validate_map_dim
from tpusvm_torch.device import host_to_device, resolve_device
from tpusvm_torch.ops.rbf import matmul_p, rbf_cross

# eigenvalue floor of the Nystrom pseudo-inverse root, relative to the
# largest eigenvalue of K_mm (PSD with unit diagonal, so scale-free);
# eigenvalues below lam_max * NYSTROM_EIG_FLOOR are clamped up to it
NYSTROM_EIG_FLOOR = 1e-7


# ----------------------------------------------------------- parameter draws
def rff_omega(n_features: int, D: int, gamma: float, seed: int) -> np.ndarray:
    """The (d, D/2) Gaussian frequency matrix omega ~ N(0, 2*gamma*I),
    float32: (d, D, gamma, seed) regenerate it exactly, so an rff artifact
    stores none of it."""
    validate_map_dim(D, "rff_dim")
    rng = np.random.default_rng(seed)
    scale = np.sqrt(2.0 * gamma)
    return (rng.standard_normal((n_features, D // 2))
            * scale).astype(np.float32)


def nystrom_landmark_indices(n: int, k: int, seed: int) -> np.ndarray:
    """The k landmark row indices: the first k entries of the seeded
    permutation of range(n), sorted (a streamed fit gathers exactly these
    global rows from the manifest)."""
    if k > n:
        raise ValueError(
            f"nystrom needs landmarks <= n rows, got landmarks={k} > n={n}"
        )
    return np.sort(np.random.default_rng(seed).permutation(n)[:k])


def nystrom_weights(landmarks: np.ndarray, gamma: float,
                    eig_floor: float = NYSTROM_EIG_FLOOR) -> np.ndarray:
    """The (k, k) eigenvalue-floored inverse root of K(M, M), float32:
    W = U diag(1/sqrt(max(lam, lam_max*eig_floor))) U^T, in f64."""
    M = np.asarray(landmarks, np.float64)
    sq = (M * M).sum(axis=1)
    K_mm = np.exp(-gamma * np.maximum(
        sq[:, None] + sq[None, :] - 2.0 * (M @ M.T), 0.0))
    lam, U = np.linalg.eigh(K_mm)
    floor = max(float(lam[-1]), 0.0) * eig_floor
    lam = np.maximum(lam, max(floor, np.finfo(np.float64).tiny))
    W = (U / np.sqrt(lam)) @ U.T
    return W.astype(np.float32)


# ----------------------------------------------------------------- transforms
def apply_map(family: str, X: torch.Tensor,
              arrays: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Phi(X) for (m, d) rows X and the map's parameters on X's device:
    rff (omega,) -> (m, D); nystrom (landmarks, W, gamma) -> (m, k)."""
    if family == "rff":
        (omega,) = arrays
        dots = matmul_p(X, omega.to(X.dtype))
        # the JAX map's f32 scale sqrt(2/D), as an exact Python float (no
        # host-to-device copy)
        scale = float(np.float32(np.sqrt(1.0 / omega.shape[1])))
        return scale * torch.cat([torch.cos(dots), torch.sin(dots)], dim=-1)
    if family == "nystrom":
        landmarks, W, gamma = arrays
        K_nm = rbf_cross(X, landmarks.to(X.dtype), gamma)
        return matmul_p(K_nm, W.to(X.dtype))
    raise ValueError(
        f"unknown approximate family {family!r}; supported: "
        f"{list(APPROX_FAMILIES)}"
    )


def approx_decision_function(Xq: torch.Tensor, fmap: "FeatureMap",
                             X_sv: torch.Tensor, coef: torch.Tensor,
                             b, block: int = 2048) -> torch.Tensor:
    """f(x) = Phi(x).sum_j coef_j Phi(x_j) - b for raw scaled rows Xq on
    the card: the map, then the linear decision over the MAPPED support
    rows X_sv (models store mapped rows). coef (n_sv,) gives (m,) scores,
    (n_sv, K) one-vs-rest's (m, K). The raw rows are zero-padded to a
    multiple of `block` BEFORE the map, so the map's products run one
    shape per block whatever m is (solver/predict.py: a row's score is
    then the same bits alone or among thousands)."""
    from tpusvm_torch.solver.predict import decision_function, pad_rows

    m = Xq.shape[0]
    Z = fmap.transform(pad_rows(Xq, block))
    return decision_function(Z, X_sv, coef, b, gamma=0.0,
                             kernel=fmap.family, block=block)[:m]


# -------------------------------------------------------------- the map object
@dataclasses.dataclass
class FeatureMap:
    """One fitted approximate feature map: family + its parameter arrays.

    arrays: rff -> (omega,); nystrom -> (landmarks, W, gamma0d), float32
    numpy on the host. transform() copies them to the input's device once
    and keeps the copy for later calls there.
    """

    family: str
    arrays: Tuple[np.ndarray, ...]
    n_features_in: int
    seed: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def dim(self) -> int:
        """Mapped feature width D (rff: 2 * D/2 draws; nystrom: k)."""
        if self.family == "rff":
            return 2 * self.arrays[0].shape[1]
        return self.arrays[1].shape[1]

    def device_arrays(self, device) -> Tuple[torch.Tensor, ...]:
        """The parameter arrays on `device`, copied there once."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = tuple(
                host_to_device(np.asarray(a), None, device)
                for a in self.arrays)
        return self._on_device[key]

    def transform(self, X: torch.Tensor) -> torch.Tensor:
        """Phi(X) on X's device; X is (m, n_features_in)."""
        if X.shape[-1] != self.n_features_in:
            raise ValueError(
                f"{self.family} map expects {self.n_features_in} features, "
                f"got {X.shape[-1]}")
        return apply_map(self.family, X, self.device_arrays(X.device))

    def transform_np(self, X: np.ndarray, dtype=np.float32,
                     device="cuda") -> np.ndarray:
        """Host rows in, host mapped rows out: cast to `dtype`, copy to
        `device` ("cuda" unless asked otherwise), map there, copy back.
        The round trip per call is what the streamed fit avoids (it maps
        in the reader's hook and keeps the block on the card)."""
        dev = resolve_device(device)
        Xd = torch.as_tensor(np.asarray(X, dtype), device=dev)
        return self.transform(Xd).cpu().numpy()

    # --------------------------------------------------------- persistence
    def state_entries(self) -> dict:
        """npz state entries (serialization format v4): rff stores only
        the input width (the config regenerates omega); nystrom stores its
        landmark rows and inverse-root weights."""
        entries = {"map_n_features_in": np.int64(self.n_features_in)}
        if self.family == "nystrom":
            entries["map_landmarks"] = self.arrays[0]
            entries["map_weights"] = self.arrays[1]
        return entries


def build_map(config: SVMConfig, X_scaled: Optional[np.ndarray] = None,
              n_features: Optional[int] = None,
              landmark_rows: Optional[np.ndarray] = None) -> FeatureMap:
    """Fit the config's approximate map, on the host.

    rff needs only the input width (n_features, or X_scaled for it);
    nystrom needs landmark rows: X_scaled (indices drawn by
    nystrom_landmark_indices over its rows) or landmark_rows directly (a
    streamed fit gathers the same seeded rows from the manifest)."""
    family = config.kernel
    if family not in APPROX_FAMILIES:
        raise ValueError(
            f"build_map: {family!r} is not an approximate family "
            f"({list(APPROX_FAMILIES)})"
        )
    if family == "rff":
        if n_features is None:
            if X_scaled is None:
                raise ValueError("build_map(rff): pass X_scaled or "
                                 "n_features")
            n_features = int(X_scaled.shape[1])
        omega = rff_omega(n_features, config.rff_dim, config.gamma,
                          config.map_seed)
        return FeatureMap("rff", (omega,), n_features, config.map_seed)
    if landmark_rows is None:
        if X_scaled is None:
            raise ValueError("build_map(nystrom): pass X_scaled or "
                             "landmark_rows")
        idx = nystrom_landmark_indices(len(X_scaled), config.landmarks,
                                       config.map_seed)
        landmark_rows = np.asarray(X_scaled)[idx]
    landmarks = np.asarray(landmark_rows, np.float32)
    if landmarks.shape[0] != config.landmarks:
        raise ValueError(
            f"build_map(nystrom): got {landmarks.shape[0]} landmark rows, "
            f"config says landmarks={config.landmarks}"
        )
    W = nystrom_weights(landmarks, config.gamma)
    gamma0d = np.float32(config.gamma)
    return FeatureMap("nystrom", (landmarks, W, gamma0d),
                      int(landmarks.shape[1]), config.map_seed)


def map_from_state(state: dict, config: SVMConfig) -> FeatureMap:
    """Rebuild the fitted map from a loaded v4 state dict and its config."""
    if "map_n_features_in" not in state:
        raise ValueError(
            f"model names approximate kernel {config.kernel!r} but its "
            "state carries no map provenance (map_n_features_in): the "
            "artifact predates serialization v4 or was tampered with"
        )
    d = int(np.asarray(state["map_n_features_in"]))
    if config.kernel == "rff":
        omega = rff_omega(d, config.rff_dim, config.gamma, config.map_seed)
        return FeatureMap("rff", (omega,), d, config.map_seed)
    landmarks = np.asarray(state["map_landmarks"], np.float32)
    W = np.asarray(state["map_weights"], np.float32)
    return FeatureMap("nystrom", (landmarks, W, np.float32(config.gamma)),
                      d, config.map_seed)


def kernel_approx_error(X: np.ndarray, fmap: FeatureMap, gamma: float,
                        n_pairs: int = 2048, seed: int = 0,
                        device="cuda") -> float:
    """max |K_hat - K| over seeded sampled row pairs: K the exact rbf
    kernel in f64, K_hat = Phi(a).Phi(b) with the map on `device`. Falls
    with D (benchmarks/approx_scale.py's probe)."""
    rng = np.random.default_rng(seed)
    n = len(X)
    ii = rng.integers(0, n, n_pairs)
    jj = rng.integers(0, n, n_pairs)
    A, B = np.asarray(X, np.float64)[ii], np.asarray(X, np.float64)[jj]
    K = np.exp(-gamma * ((A - B) ** 2).sum(axis=1))
    Za = fmap.transform_np(A, device=device).astype(np.float64)
    Zb = fmap.transform_np(B, device=device).astype(np.float64)
    K_hat = (Za * Zb).sum(axis=1)
    return float(np.abs(K_hat - K).max())
