"""Hyperparameter-search suggestion engines, the port's copy of
``polyaxon_tpu/hpsearch/search_managers.py``: grid (cartesian product),
random (seeded sampling), hyperband (bracket math) and Bayesian optimization
(a featurized space, a Gaussian process, UCB/EI/POI acquisition).
Everything is deterministic under a seed; numpy Generators only (no global
RNG state).

The one departure: the reference fits scikit-learn's
``GaussianProcessRegressor``; the port has no scikit-learn, so
:class:`GaussianProcess` is its own copy of that regressor in numpy and
scipy: RBF and Matern kernels (``nu`` 0.5, 1.5 and 2.5 in closed form, any
other ``nu`` through ``scipy.special.kv`` with a finite-difference gradient),
``normalize_y``, ``alpha`` on the diagonal, a Cholesky solve, the predictive
variance clipped at 0; and, where ``n_restarts_optimizer`` > 0, L-BFGS-B on
the negative log marginal likelihood over ``log(length_scale)`` within
(1e-5, 1e5), from the configured value and then from
``n_restarts_optimizer`` starts drawn from ``RandomState(0)``, keeping the
best.  scipy is imported only where BO runs.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.schemas.hptuning import HPTuningConfig, Optimization, SearchAlgorithms
from polyaxon_tpu_torch.schemas.matrix import MatrixConfig

Suggestion = Dict[str, Any]


class SearchError(PolyaxonTPUError):
    pass


def _native(value: Any) -> Any:
    """numpy scalar -> json-friendly python scalar."""
    if isinstance(value, np.generic):
        return value.item()
    return value


def _sample_matrix(
    matrix: Dict[str, MatrixConfig], rng: np.random.Generator
) -> Suggestion:
    return {name: _native(m.sample(rng)) for name, m in matrix.items()}


class GridSearchManager:
    """Cartesian product over enumerable matrix params."""

    def __init__(self, hptuning: HPTuningConfig) -> None:
        self.hptuning = hptuning

    def get_suggestions(self, iteration_data: Optional[dict] = None) -> List[Suggestion]:
        names, spaces = [], []
        for name, m in self.hptuning.matrix.items():
            if m.is_distribution:
                raise SearchError(
                    f"Grid search needs enumerable params; {name!r} ({m.op}) is a "
                    "continuous distribution"
                )
            names.append(name)
            spaces.append([_native(v) for v in m.to_numpy()])
        combos = itertools.product(*spaces)
        limit = (
            self.hptuning.grid_search.n_experiments
            if self.hptuning.grid_search and self.hptuning.grid_search.n_experiments
            else None
        )
        suggestions = [dict(zip(names, c)) for c in itertools.islice(combos, limit)]
        return suggestions


class RandomSearchManager:
    """N seeded samples from the matrix."""

    def __init__(self, hptuning: HPTuningConfig) -> None:
        self.hptuning = hptuning

    def get_suggestions(self, iteration_data: Optional[dict] = None) -> List[Suggestion]:
        cfg = self.hptuning.random_search
        seed = cfg.seed if cfg.seed is not None else self.hptuning.seed
        rng = np.random.default_rng(seed)
        return [
            _sample_matrix(self.hptuning.matrix, rng) for _ in range(cfg.n_experiments)
        ]


class HyperbandSearchManager:
    """Successive-halving brackets (Li et al. 2016).

    Parity targets: ``hpsearch/search_managers/hyperband.py:9-147`` —
    ``s_max``/``B``, ``get_n_configs``, ``get_resources_for_iteration``,
    ``get_n_config_to_keep``, ``should_reschedule``/``should_reduce_configs``.
    """

    def __init__(self, hptuning: HPTuningConfig) -> None:
        self.hptuning = hptuning
        self.config = hptuning.hyperband
        self.max_iterations = self.config.max_iterations
        self.eta = self.config.eta
        #: number of brackets - 1
        self.s_max = int(math.log(self.max_iterations) / math.log(self.eta))
        #: total budget (per bracket): (s_max + 1) * max_iterations
        self.B = (self.s_max + 1) * self.max_iterations

    # -- bracket math ---------------------------------------------------------
    def get_bracket(self, iteration: int) -> int:
        """Bracket s for the 0-based outer iteration (s counts DOWN)."""
        return self.s_max - iteration

    def get_n_configs(self, bracket: int) -> int:
        return int(
            math.ceil((self.B / self.max_iterations) * (self.eta**bracket) / (bracket + 1))
        )

    def get_resources(self, bracket: int) -> float:
        return self.max_iterations * (self.eta**-bracket)

    def get_resources_for_iteration(self, iteration: int) -> float:
        return self.get_resources(self.get_bracket(iteration))

    def get_n_config_to_keep(self, n_suggestions: int, bracket_iteration: int) -> int:
        """How many configs survive step ``bracket_iteration`` of a bracket."""
        n_configs = n_suggestions * (self.eta**-bracket_iteration)
        return int(n_configs / self.eta)

    def get_n_config_to_keep_for_iteration(
        self, iteration: int, bracket_iteration: int
    ) -> int:
        bracket = self.get_bracket(iteration)
        return self.get_n_config_to_keep(self.get_n_configs(bracket), bracket_iteration)

    def should_reschedule(self, iteration: int, bracket_iteration: int) -> bool:
        """Start a new bracket after the current one is exhausted?"""
        if self.should_reduce_configs(iteration, bracket_iteration):
            return False
        return iteration + 1 <= self.s_max

    def should_reduce_configs(self, iteration: int, bracket_iteration: int) -> bool:
        """Continue inside the bracket with the top-k configs?"""
        bracket = self.get_bracket(iteration)
        return bracket_iteration + 1 <= bracket

    # -- suggestions ----------------------------------------------------------
    def get_suggestions(self, iteration_data: Optional[dict] = None) -> List[Suggestion]:
        """Fresh random configs for a bracket's first step, with the resource
        param injected (``hyperband.py:115-131``)."""
        iteration = (iteration_data or {}).get("iteration", 0)
        bracket = self.get_bracket(iteration)
        n_configs = self.get_n_configs(bracket)
        resource = self.get_resources(bracket)
        seed = self.config.seed if self.config.seed is not None else self.hptuning.seed
        rng = np.random.default_rng(None if seed is None else seed + iteration)
        suggestions = []
        for _ in range(n_configs):
            s = _sample_matrix(self.hptuning.matrix, rng)
            s[self.config.resource.name] = self._format_resource(resource)
            suggestions.append(s)
        return suggestions

    def reduce_configs(
        self,
        iteration: int,
        bracket_iteration: int,
        configs: Sequence[Suggestion],
        metrics: Sequence[Optional[float]],
    ) -> List[Suggestion]:
        """Top-k configs for the next bracket step, resource re-injected.

        The wave passed in is already ``n_orig * eta^-bracket_iteration``
        strong, so the survivors of this step are ``len(configs) / eta`` —
        deriving from the actual wave keeps halving correct even when
        failed trials were dropped.
        """
        k = int(len(configs) / self.eta)
        reverse = self.config.metric.optimization == Optimization.MAXIMIZE
        scored = [
            (m, c) for m, c in zip(metrics, configs) if m is not None
        ]
        scored.sort(key=lambda mc: mc[0], reverse=reverse)
        survivors = [dict(c) for _, c in scored[:k]]
        resource = self.get_resources(self.get_bracket(iteration)) * (
            self.eta ** (bracket_iteration + 1)
        )
        resource = min(resource, self.max_iterations)
        for s in survivors:
            s[self.config.resource.name] = self._format_resource(resource)
        return survivors

    def _format_resource(self, resource: float) -> Any:
        # Integer resources stay ints (epochs/steps); eta may be fractional.
        r = round(resource, 6)
        return int(r) if float(r).is_integer() else r


class SearchSpace:
    """Featurizer: suggestion dict <-> continuous optimization vector.

    Parity: ``hpsearch/search_managers/bayesian_optimization/space.py:9-60``
    — continuous dims pass through with bounds, discrete dims become index
    dims, categorical dims one-hot.
    """

    def __init__(self, matrix: Dict[str, MatrixConfig]) -> None:
        self.matrix = dict(matrix)
        self.names: List[str] = []
        self.bounds: List[Tuple[float, float]] = []
        #: per-feature decoder: (kind, param name, payload)
        self._features: List[Tuple[str, str, Any]] = []
        for name, m in matrix.items():
            self.names.append(name)
            if m.is_categorical:
                values = [_native(v) for v in m.to_numpy()]
                for v in values:
                    self.bounds.append((0.0, 1.0))
                    self._features.append(("onehot", name, values))
            elif m.is_discrete:
                values = sorted(_native(v) for v in m.to_numpy())
                self.bounds.append((0.0, len(values) - 1e-9))
                self._features.append(("index", name, values))
            else:
                self.bounds.append((float(m.min), float(m.max)))
                self._features.append(("continuous", name, None))

    @property
    def dim(self) -> int:
        return len(self.bounds)

    def to_vector(self, suggestion: Suggestion) -> np.ndarray:
        vec = np.zeros(self.dim)
        i = 0
        while i < self.dim:
            kind, name, payload = self._features[i]
            if kind == "onehot":
                values = payload
                idx = values.index(suggestion[name])
                vec[i : i + len(values)] = 0.0
                vec[i + idx] = 1.0
                i += len(values)
            elif kind == "index":
                values = payload
                vec[i] = values.index(suggestion[name])
                i += 1
            else:
                vec[i] = float(suggestion[name])
                i += 1
        return vec

    def to_suggestion(self, vec: np.ndarray) -> Suggestion:
        out: Suggestion = {}
        i = 0
        while i < self.dim:
            kind, name, payload = self._features[i]
            if kind == "onehot":
                values = payload
                block = vec[i : i + len(values)]
                out[name] = values[int(np.argmax(block))]
                i += len(values)
            elif kind == "index":
                values = payload
                idx = int(np.clip(round(float(vec[i])), 0, len(values) - 1))
                out[name] = values[idx]
                i += 1
            else:
                lo, hi = self.bounds[i]
                out[name] = float(np.clip(vec[i], lo, hi))
                i += 1
        return out

    def sample_vectors(self, n: int, rng: np.random.Generator) -> np.ndarray:
        lo = np.array([b[0] for b in self.bounds])
        hi = np.array([b[1] for b in self.bounds])
        return rng.uniform(lo, hi, size=(n, self.dim))


class GaussianProcess:
    """Gaussian-process regression with an isotropic RBF or Matern kernel,
    the regressor the reference takes from scikit-learn
    (``GaussianProcessRegressor(kernel, normalize_y=True, random_state=0)``
    with ``alpha`` 1e-10), written out in the same operations and order."""

    ALPHA = 1e-10
    BOUNDS = (1e-5, 1e5)

    def __init__(self, kernel: str = "matern", length_scale: float = 1.0, nu: float = 1.5,
                 n_restarts_optimizer: int = 0) -> None:
        self.kernel = kernel
        self.length_scale = length_scale
        self.nu = nu
        self.n_restarts_optimizer = n_restarts_optimizer

    # -- the kernel ------------------------------------------------------------
    def _kernel(self, length_scale, X: np.ndarray, Y: Optional[np.ndarray] = None,
                eval_gradient: bool = False):
        """k(X, Y) (k(X, X) where Y is None), and its gradient with respect
        to ``log(length_scale)`` where asked."""
        from scipy.spatial.distance import cdist, pdist, squareform

        ls = np.squeeze(length_scale).astype(float)
        if self.kernel == "rbf":
            if Y is None:
                dists = pdist(X / ls, metric="sqeuclidean")
                K = squareform(np.exp(-0.5 * dists))
                np.fill_diagonal(K, 1)
            else:
                dists = cdist(X / ls, Y / ls, metric="sqeuclidean")
                K = np.exp(-0.5 * dists)
            if eval_gradient:
                return K, (K * squareform(dists))[:, :, np.newaxis]
            return K
        nu = self.nu
        if Y is None:
            dists = pdist(X / ls, metric="euclidean")
        else:
            dists = cdist(X / ls, Y / ls, metric="euclidean")
        if nu == 0.5:
            K = np.exp(-dists)
        elif nu == 1.5:
            K = dists * math.sqrt(3)
            K = (1.0 + K) * np.exp(-K)
        elif nu == 2.5:
            K = dists * math.sqrt(5)
            K = (1.0 + K + K**2 / 3.0) * np.exp(-K)
        elif nu == np.inf:
            K = np.exp(-(dists**2) / 2.0)
        else:  # the general case, through the modified Bessel function
            from scipy.special import gamma, kv

            K = dists
            K[K == 0.0] += np.finfo(float).eps  # strict zeros give nan
            tmp = math.sqrt(2 * nu) * K
            K.fill((2 ** (1.0 - nu)) / gamma(nu))
            K *= tmp**nu
            K *= kv(nu, tmp)
        if Y is None:
            K = squareform(K)
            np.fill_diagonal(K, 1)
        if not eval_gradient:
            return K
        D = squareform(dists**2)[:, :, np.newaxis]
        if nu == 0.5:
            denominator = np.sqrt(D.sum(axis=2))[:, :, np.newaxis]
            divide_result = np.zeros_like(D)
            np.divide(D, denominator, out=divide_result, where=denominator != 0)
            K_gradient = K[..., np.newaxis] * divide_result
        elif nu == 1.5:
            K_gradient = 3 * D * np.exp(-np.sqrt(3 * D.sum(-1)))[..., np.newaxis]
        elif nu == 2.5:
            tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
            K_gradient = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
        elif nu == np.inf:
            K_gradient = D * K[..., np.newaxis]
        else:  # a forward difference in log(length_scale), step 1e-10
            theta = np.log(np.hstack([ls]))
            K0 = self._kernel(np.exp(theta), X)
            K_gradient = np.zeros((K.shape[0], K.shape[1], 1))
            K_gradient[:, :, 0] = (self._kernel(np.exp(theta + 1e-10), X) - K0) / 1e-10
        return K, K_gradient

    # -- fit -------------------------------------------------------------------
    def _neg_log_marginal_likelihood(self, theta: np.ndarray):
        """(-log p(y | X, theta), its gradient) at ``theta`` =
        ``[log(length_scale)]``."""
        from scipy.linalg import cho_solve, cholesky

        K, K_gradient = self._kernel(np.exp(theta), self.X_train_, eval_gradient=True)
        K[np.diag_indices_from(K)] += self.ALPHA
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return np.inf, np.zeros_like(theta)
        y_train = self.y_train_[:, np.newaxis]
        alpha = cho_solve((L, True), y_train, check_finite=False)
        log_likelihood_dims = -0.5 * np.einsum("ik,ik->k", y_train, alpha)
        log_likelihood_dims -= np.log(np.diag(L)).sum()
        log_likelihood_dims -= K.shape[0] / 2 * np.log(2 * np.pi)
        log_likelihood = log_likelihood_dims.sum(axis=-1)
        inner_term = np.einsum("ik,jk->ijk", alpha, alpha)
        K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
        inner_term -= K_inv[..., np.newaxis]
        gradient_dims = 0.5 * np.einsum("ijl,jik->kl", inner_term, K_gradient)
        return -log_likelihood, -gradient_dims.sum(axis=-1)

    def _minimize(self, theta0: np.ndarray, bounds: np.ndarray):
        from scipy.optimize import minimize

        res = minimize(self._neg_log_marginal_likelihood, theta0, method="L-BFGS-B",
                       jac=True, bounds=bounds)
        return res.x, res.fun

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        from scipy.linalg import cho_solve, cholesky

        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        self._y_train_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self._y_train_std = 1.0 if std == 0.0 else std
        self.X_train_ = np.copy(X)
        self.y_train_ = (y - self._y_train_mean) / self._y_train_std
        self.length_scale_ = self.length_scale
        if self.n_restarts_optimizer > 0:
            bounds = np.log(np.array([self.BOUNDS], dtype=float))
            optima = [self._minimize(np.log(np.hstack([float(self.length_scale)])), bounds)]
            rng = np.random.RandomState(0)
            for _ in range(self.n_restarts_optimizer):
                optima.append(self._minimize(rng.uniform(bounds[:, 0], bounds[:, 1]), bounds))
            theta = optima[int(np.argmin([fun for _, fun in optima]))][0]
            self.length_scale_ = np.exp(theta)
        K = self._kernel(self.length_scale_, self.X_train_)
        K[np.diag_indices_from(K)] += self.ALPHA
        self.L_ = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L_, True), self.y_train_, check_finite=False)
        return self

    @property
    def log_length_scale(self) -> float:
        """The fitted ``log(length_scale)``."""
        return float(np.log(np.squeeze(self.length_scale_)))

    def predict(self, X: np.ndarray, return_std: bool = False):
        """The posterior mean at ``X`` (and its standard deviation)."""
        from scipy.linalg import solve_triangular

        X = np.asarray(X, dtype=float)
        K_trans = self._kernel(self.length_scale_, X, self.X_train_)
        y_mean = K_trans @ self.alpha_
        y_mean = self._y_train_std * y_mean + self._y_train_mean
        if not return_std:
            return y_mean
        V = solve_triangular(self.L_, K_trans.T, lower=True, check_finite=False)
        y_var = np.ones(X.shape[0])
        y_var -= np.einsum("ij,ji->i", V.T, V)
        y_var[y_var < 0] = 0.0
        y_var = y_var * self._y_train_std**2
        return y_mean, np.sqrt(y_var)


class UtilityFunction:
    """UCB / EI / POI acquisition over a GP posterior.

    Parity: ``bayesian_optimization/acquisition_function.py:1-115``.
    """

    def __init__(self, config) -> None:
        self.config = config

    def _gp(self) -> "GaussianProcess":
        g = self.config.gaussian_process
        # n_restarts_optimizer=0 means "honor the configured length scale":
        # with few observations the marginal-likelihood fit collapses to
        # degenerate length scales and a spiky posterior.
        return GaussianProcess(
            kernel=g.kernel,
            length_scale=g.length_scale,
            nu=g.nu,
            n_restarts_optimizer=g.n_restarts_optimizer,
        )

    def acquisition(self, gp, x: np.ndarray, y_max: float) -> np.ndarray:
        from scipy import stats

        mean, std = gp.predict(x, return_std=True)
        std = np.maximum(std, 1e-9)
        kind = self.config.acquisition_function
        if kind == "ucb":
            return mean + self.config.kappa * std
        z = (mean - y_max - self.config.eps) / std
        if kind == "ei":
            return (mean - y_max - self.config.eps) * stats.norm.cdf(
                z
            ) + std * stats.norm.pdf(z)
        return stats.norm.cdf(z)  # poi

    def max_acquisition(
        self, gp, space: SearchSpace, y_max: float, rng: np.random.Generator
    ) -> np.ndarray:
        from scipy.optimize import minimize

        warmup = space.sample_vectors(self.config.n_warmup, rng)
        scores = self.acquisition(gp, warmup, y_max)
        best = warmup[int(np.argmax(scores))]
        best_score = float(np.max(scores))
        # Polish the best random candidates with L-BFGS-B.
        for x0 in space.sample_vectors(self.config.n_iter, rng):
            res = minimize(
                lambda x: -self.acquisition(gp, x.reshape(1, -1), y_max)[0],
                x0,
                bounds=space.bounds,
                method="L-BFGS-B",
            )
            if res.success and -res.fun > best_score:
                best, best_score = res.x, -res.fun
        return best


class BOSearchManager:
    """Seed round of random trials, then GP-posterior acquisition.

    Parity: ``bayesian_optimization/manager.py:7-41``.
    """

    def __init__(self, hptuning: HPTuningConfig) -> None:
        self.hptuning = hptuning
        self.config = hptuning.bo
        self.space = SearchSpace(hptuning.matrix)
        self.utility = UtilityFunction(self.config.utility_function)

    def _rng(self, salt: int = 0) -> np.random.Generator:
        seed = self.config.seed if self.config.seed is not None else self.hptuning.seed
        return np.random.default_rng(None if seed is None else seed + salt)

    def get_suggestions(self, iteration_data: Optional[dict] = None) -> List[Suggestion]:
        data = iteration_data or {}
        configs = data.get("configs") or []
        metrics = data.get("metrics") or []
        if not configs:
            rng = self._rng()
            return [
                _sample_matrix(self.hptuning.matrix, rng)
                for _ in range(self.config.n_initial_trials)
            ]
        observed = [
            (c, m) for c, m in zip(configs, metrics) if m is not None
        ]
        if not observed:
            return [_sample_matrix(self.hptuning.matrix, self._rng(1))]
        x = np.stack([self.space.to_vector(c) for c, _ in observed])
        y = np.array([m for _, m in observed], dtype=float)
        if self.config.metric.optimization == Optimization.MINIMIZE:
            y = -y
        gp = self.utility._gp()
        gp.fit(x, y)
        rng = self._rng(len(observed))
        vec = self.utility.max_acquisition(gp, self.space, float(np.max(y)), rng)
        return [self.space.to_suggestion(vec)]


def get_search_manager(hptuning: HPTuningConfig):
    algo = hptuning.search_algorithm
    return {
        SearchAlgorithms.GRID: GridSearchManager,
        SearchAlgorithms.RANDOM: RandomSearchManager,
        SearchAlgorithms.HYPERBAND: HyperbandSearchManager,
        SearchAlgorithms.BO: BOSearchManager,
    }[algo](hptuning)
