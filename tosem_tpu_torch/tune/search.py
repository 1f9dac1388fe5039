"""Search spaces and suggestion algorithms for the HPO layer.

Covers the reference's search-algorithm surface (SURVEY §2.1 Ray Tune
``suggest/``, §2.4 NNI ``nni/algorithms/hpo/``): sampling domains
(``tune.uniform/loguniform/choice/randint/grid_search``), random and grid
search, a TPE-style density-ratio suggester (the hyperopt_tuner.py role), and
a μ+λ evolutionary suggester (evolution_tuner.py / TPOT's eaMuPlusLambda
role). All numpy-only, deterministic under seed.

The port's copy of ``tosem_tpu/tune/search.py``: from the same seed and
the same observations, each searcher suggests the JAX package's configs.
"""
from __future__ import annotations

import itertools
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------- domains

class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    # numeric domains support vectorized density fitting for TPE
    def to_unit(self, v) -> Optional[float]:
        return None

    def from_unit(self, u: float):
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return rng.uniform(self.low, self.high)

    def to_unit(self, v):
        return (v - self.low) / (self.high - self.low)

    def from_unit(self, u):
        return self.low + u * (self.high - self.low)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        if low <= 0:
            raise ValueError("loguniform needs low > 0")
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))

    def to_unit(self, v):
        return (math.log(v) - math.log(self.low)) / (
            math.log(self.high) - math.log(self.low))

    def from_unit(self, u):
        return math.exp(math.log(self.low) +
                        u * (math.log(self.high) - math.log(self.low)))


class RandInt(Domain):
    def __init__(self, low: int, high: int):  # [low, high)
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return rng.randrange(self.low, self.high)

    def to_unit(self, v):
        return (v - self.low) / max(1, self.high - 1 - self.low)

    def from_unit(self, u):
        return int(round(self.low + u * (self.high - 1 - self.low)))


class Choice(Domain):
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


class GridValues:
    """Marker for exhaustive expansion (``tune.grid_search([...])``)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(values) -> Choice:
    return Choice(values)


def grid_search(values) -> GridValues:
    return GridValues(values)


def sample_config(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, GridValues):
            out[k] = rng.choice(v.values)
        else:
            out[k] = v
    return out


# ------------------------------------------------------------- suggesters

class SearchAlgorithm:
    """Suggest trial configs; observe (config, score) to adapt."""

    def set_space(self, space: Dict[str, Any], mode: str) -> None:
        self.space = space
        self.mode = mode  # "min" | "max"

    def suggest(self) -> Dict[str, Any]:
        raise NotImplementedError

    def observe(self, config: Dict[str, Any], score: float,
                budget: Optional[float] = None) -> None:
        """``budget``: fidelity of the observation (training iteration) —
        consumed by multi-fidelity suggesters (BOHB), ignored elsewhere."""
        pass


class RandomSearch(SearchAlgorithm):
    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)

    def suggest(self):
        return sample_config(self.space, self.rng)


class GridSearch(SearchAlgorithm):
    """Cross-product over ``grid_search`` entries; non-grid Domains sampled."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)
        self._iter = None

    def set_space(self, space, mode):
        super().set_space(space, mode)
        grids = {k: v.values for k, v in space.items()
                 if isinstance(v, GridValues)}
        keys = list(grids)
        combos = itertools.product(*[grids[k] for k in keys]) if keys else [()]
        self._iter = itertools.cycle([dict(zip(keys, c)) for c in combos])

    def grid_size(self) -> int:
        n = 1
        for v in self.space.values():
            if isinstance(v, GridValues):
                n *= len(v.values)
        return n

    def suggest(self):
        fixed = next(self._iter)
        cfg = sample_config(
            {k: v for k, v in self.space.items()
             if not isinstance(v, GridValues)}, self.rng)
        cfg.update(fixed)
        return cfg


class TPESearch(SearchAlgorithm):
    """Tree-of-Parzen-Estimators-style suggester (hyperopt_tuner.py role).

    Splits observations at the ``gamma`` quantile into good/bad sets, fits a
    per-dimension Parzen (Gaussian-kernel) density to each in unit space, and
    suggests the candidate maximizing good/bad density ratio. Categorical
    dims use smoothed empirical frequencies.
    """

    def __init__(self, seed: Optional[int] = None, n_startup: int = 10,
                 n_candidates: int = 24, gamma: float = 0.25):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.obs: List[Tuple[Dict[str, Any], float]] = []

    def observe(self, config, score, budget=None):
        self.obs.append((config, score))

    def _split(self):
        scores = np.array([s for _, s in self.obs], dtype=float)
        if self.mode == "max":
            scores = -scores
        k = max(1, int(math.ceil(self.gamma * len(scores))))
        order = np.argsort(scores)
        good = [self.obs[i][0] for i in order[:k]]
        bad = [self.obs[i][0] for i in order[k:]] or good
        return good, bad

    @staticmethod
    def _parzen_logpdf(x: float, samples: np.ndarray) -> float:
        if len(samples) == 0:
            return 0.0
        bw = max(1.0 / (1 + len(samples)), samples.std() + 1e-3)
        z = (x - samples) / bw
        return float(np.log(np.mean(np.exp(-0.5 * z * z) /
                                    (bw * np.sqrt(2 * np.pi))) + 1e-12))

    def suggest(self):
        if len(self.obs) < self.n_startup:
            return sample_config(self.space, self.rng)
        good, bad = self._split()
        best_cfg, best_ratio = None, -np.inf
        for _ in range(self.n_candidates):
            cfg = {}
            ratio = 0.0
            for key, dom in self.space.items():
                if isinstance(dom, Domain) and dom.to_unit(
                        good[0].get(key, None) if good else None) is not None:
                    g = np.array([dom.to_unit(c[key]) for c in good])
                    b = np.array([dom.to_unit(c[key]) for c in bad])
                    # sample around a good observation (Parzen draw)
                    center = float(self.np_rng.choice(g))
                    bw = max(1.0 / (1 + len(g)), g.std() + 1e-3)
                    u = float(np.clip(self.np_rng.normal(center, bw), 0, 1))
                    cfg[key] = dom.from_unit(u)
                    ratio += (self._parzen_logpdf(u, g) -
                              self._parzen_logpdf(u, b))
                elif isinstance(dom, (Choice, GridValues)):
                    values = dom.values
                    gc = [c[key] for c in good]
                    bc = [c[key] for c in bad]
                    # smoothed empirical frequencies
                    def freq(v, obs_list):
                        return (obs_list.count(v) + 1.0) / (
                            len(obs_list) + len(values))
                    weights = [freq(v, gc) for v in values]
                    total = sum(weights)
                    r = self.np_rng.random() * total
                    acc = 0.0
                    pick = values[-1]
                    for v, w in zip(values, weights):
                        acc += w
                        if r <= acc:
                            pick = v
                            break
                    cfg[key] = pick
                    ratio += math.log(freq(pick, gc) / freq(pick, bc))
                elif isinstance(dom, Domain):
                    cfg[key] = dom.sample(self.rng)
                else:
                    cfg[key] = dom
            if ratio > best_ratio:
                best_ratio, best_cfg = ratio, cfg
        return best_cfg


class EvolutionSearch(SearchAlgorithm):
    """μ+λ evolutionary suggester (NNI evolution_tuner / TPOT GP loop role):
    parents = top half of observed; children = crossover + per-key mutation."""

    def __init__(self, seed: Optional[int] = None, population: int = 10,
                 mutation_prob: float = 0.3):
        self.rng = random.Random(seed)
        self.population = population
        self.mutation_prob = mutation_prob
        self.obs: List[Tuple[Dict[str, Any], float]] = []

    def observe(self, config, score, budget=None):
        self.obs.append((config, score))

    def suggest(self):
        if len(self.obs) < self.population:
            return sample_config(self.space, self.rng)
        ranked = sorted(self.obs, key=lambda cs: cs[1],
                        reverse=(self.mode == "max"))
        parents = [c for c, _ in ranked[:max(2, len(ranked) // 2)]]
        a, b = self.rng.sample(parents, 2)
        child = {}
        for k in self.space:
            child[k] = (a if self.rng.random() < 0.5 else b).get(k)
            if self.rng.random() < self.mutation_prob:
                dom = self.space[k]
                if isinstance(dom, Domain) and \
                        dom.to_unit(child[k]) is not None:
                    # local gaussian step in unit space (with a 20% chance
                    # of a full resample to keep exploring)
                    if self.rng.random() < 0.2:
                        child[k] = dom.sample(self.rng)
                    else:
                        u = dom.to_unit(child[k])
                        u = min(1.0, max(0.0, self.rng.gauss(u, 0.08)))
                        child[k] = dom.from_unit(u)
                elif isinstance(dom, Domain):
                    child[k] = dom.sample(self.rng)
                elif isinstance(dom, GridValues):
                    child[k] = self.rng.choice(dom.values)
        return child


# -------------------------------------------------- model-based suggesters

def _space_encoder(space: Dict[str, Any]):
    """Build encode/decode between configs and a unit hypercube.

    Numeric domains map through ``to_unit``; ``Choice``/``GridValues``
    expand to one-hot blocks (the encoding SMAC-style surrogates use for
    categoricals). → (encode(cfg) -> np.ndarray, dim, columns) where
    columns[j] = (key, kind, payload) for decoding.
    """
    cols: List[Tuple[str, str, Any]] = []
    constants: Dict[str, Any] = {}
    for k in sorted(space):
        dom = space[k]
        if isinstance(dom, (GridValues, Choice)):
            for v in dom.values:
                cols.append((k, "onehot", v))
        elif not isinstance(dom, Domain):
            constants[k] = dom      # fixed value: no search dimension
        elif dom.to_unit(dom.sample(random.Random(0))) is not None:
            cols.append((k, "unit", dom))
        else:  # pragma: no cover - exotic custom domain
            cols.append((k, "raw", None))

    def encode(cfg: Dict[str, Any]) -> np.ndarray:
        x = np.zeros(len(cols))
        for j, (k, kind, payload) in enumerate(cols):
            if kind == "onehot":
                x[j] = 1.0 if cfg.get(k) == payload else 0.0
            elif kind == "unit":
                x[j] = float(np.clip(payload.to_unit(cfg[k]), 0.0, 1.0))
            else:
                x[j] = float(cfg.get(k, 0.0))
        return x

    return encode, len(cols), cols, constants


class GPSearch(SearchAlgorithm):
    """Gaussian-process surrogate + expected improvement.

    The model-based BO role of the reference's SMAC/GP/Metis tuners
    (``nni/algorithms/hpo/smac_tuner/``, ``gp_tuner/``,
    ``metis_tuner/``): RBF-kernel GP over unit-cube-encoded configs
    (categoricals one-hot), EI acquisition maximized over a random
    candidate pool. Pure NumPy — Cholesky posterior, no dependencies.
    """

    def __init__(self, seed: Optional[int] = None, n_startup: int = 8,
                 n_candidates: int = 256, lengthscale: float = 0.3,
                 noise: float = 1e-6):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.ls = lengthscale
        self.noise = noise
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    def set_space(self, space, mode):
        super().set_space(space, mode)
        self._encode, self._dim, self._cols, self._consts = \
            _space_encoder(space)

    def observe(self, config, score, budget=None):
        s = float(score)
        self.X.append(self._encode(config))
        self.y.append(-s if self.mode == "min" else s)

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2))

    def suggest(self):
        if len(self.y) < self.n_startup:
            return sample_config(self.space, self.rng)
        X = np.stack(self.X)
        y = np.asarray(self.y)
        mu_y, sd_y = y.mean(), y.std() + 1e-9
        yn = (y - mu_y) / sd_y
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        cands = [sample_config(self.space, self.rng)
                 for _ in range(self.n_candidates)]
        C = np.stack([self._encode(c) for c in cands])
        Ks = self._kernel(C, X)                       # [m, n]
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)                  # [n, m]
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sd = np.sqrt(var)
        best = yn.max()
        z = (mu - best) / sd
        # EI with the standard normal via erf (no scipy dependency)
        pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = sd * (z * cdf + pdf)
        return cands[int(np.argmax(ei))]


class BOHBSearch(SearchAlgorithm):
    """KDE-guided multi-fidelity suggester (the BOHB model).

    The reference's ``nni/algorithms/hpo/bohb_advisor/`` fits TPE-style
    good/bad kernel-density models PER BUDGET and samples configs that
    maximize the density ratio, falling back to random with probability
    ``random_fraction``. Pair with :class:`~tosem_tpu_torch.tune.schedulers.
    HyperBandScheduler` for the bracket half of BOHB — the tune runner
    feeds ``observe(config, score, budget=iteration)`` so the model of the
    highest sufficiently-populated budget drives sampling.
    """

    def __init__(self, seed: Optional[int] = None, min_points: int = 8,
                 top_fraction: float = 0.25, random_fraction: float = 0.2,
                 n_samples: int = 64, bandwidth: float = 0.1):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.min_points = min_points
        self.top_fraction = top_fraction
        self.random_fraction = random_fraction
        self.n_samples = n_samples
        self.bw = bandwidth
        self.obs: Dict[float, List[Tuple[np.ndarray, float]]] = {}

    def set_space(self, space, mode):
        super().set_space(space, mode)
        self._encode, self._dim, self._cols, self._consts = \
            _space_encoder(space)

    def observe(self, config, score, budget=None):
        s = float(score)
        if self.mode == "min":
            s = -s
        b = float(budget if budget is not None else 1.0)
        self.obs.setdefault(b, []).append((self._encode(config), s))

    def _model_budget(self) -> Optional[float]:
        for b in sorted(self.obs, reverse=True):
            if len(self.obs[b]) >= self.min_points:
                return b
        return None

    def _log_kde(self, X: np.ndarray, q: np.ndarray) -> np.ndarray:
        d2 = ((q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        return np.log(np.exp(-0.5 * d2 / self.bw ** 2).mean(1) + 1e-300)

    def suggest(self):
        b = self._model_budget()
        if b is None or self.rng.random() < self.random_fraction:
            return sample_config(self.space, self.rng)
        pts = self.obs[b]
        pts_sorted = sorted(pts, key=lambda p: -p[1])
        n_good = max(2, int(len(pts) * self.top_fraction))
        good = np.stack([p[0] for p in pts_sorted[:n_good]])
        bad = np.stack([p[0] for p in pts_sorted[n_good:]]) \
            if len(pts) > n_good else good
        # candidates: jitter around good points (BOHB's sample-from-l(x))
        centers = good[self.np_rng.integers(0, len(good), self.n_samples)]
        cands = centers + self.np_rng.normal(0, self.bw,
                                             centers.shape)
        ratio = self._log_kde(good, cands) - self._log_kde(bad, cands)
        best = cands[int(np.argmax(ratio))]
        return self._decode(np.clip(best, 0.0, 1.0))

    def _decode(self, x: np.ndarray) -> Dict[str, Any]:
        return _decode_vector(x, self._cols, self._consts)


def _decode_vector(x: np.ndarray, cols, constants) -> Dict[str, Any]:
    """Inverse of ``_space_encoder``'s encode: unit-cube point → config
    (one-hot blocks decode by argmax)."""
    cfg: Dict[str, Any] = {}
    onehot: Dict[str, List[Tuple[float, Any]]] = {}
    for j, (k, kind, payload) in enumerate(cols):
        if kind == "onehot":
            onehot.setdefault(k, []).append((x[j], payload))
        elif kind == "unit":
            cfg[k] = payload.from_unit(float(np.clip(x[j], 0, 1)))
        else:
            cfg[k] = float(x[j])
    for k, opts in onehot.items():
        cfg[k] = max(opts, key=lambda o: o[0])[1]
    cfg.update(constants)
    return cfg


class PSOSearch(SearchAlgorithm):
    """Particle-swarm suggester — the NuPIC swarming algorithm.

    The reference's swarming/HyperSearch (``nupic/swarming/hypersearch/
    particle.py``, ``permutations_runner.py``) *is* particle-swarm
    optimization over permutation variables; this is the same dynamics
    over the unit-cube encoding: ``v ← ω·v + c1·r1·(pbest − x) +
    c2·r2·(gbest − x)``, asynchronous (each observe updates one particle
    and steps it), categoricals riding the one-hot block relaxation.
    """

    def __init__(self, seed: Optional[int] = None, n_particles: int = 8,
                 inertia: float = 0.7, c1: float = 1.4, c2: float = 1.4,
                 v_max: float = 0.25):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.n_particles = n_particles
        self.w, self.c1, self.c2, self.v_max = inertia, c1, c2, v_max
        self._next = 0

    def set_space(self, space, mode):
        super().set_space(space, mode)
        self._encode, self._dim, self._cols, self._consts = \
            _space_encoder(space)
        d = max(self._dim, 1)
        self.x = self.np_rng.uniform(0, 1, (self.n_particles, d))
        self.v = self.np_rng.uniform(-0.1, 0.1, (self.n_particles, d))
        self.pbest = self.x.copy()
        self.pbest_score = np.full(self.n_particles, -np.inf)
        self.gbest = self.x[0].copy()
        self.gbest_score = -np.inf
        # FIFO per config key: distinct particles can decode to the SAME
        # config (categorical-heavy spaces). Observations accumulate into
        # the particle's per-suggestion best; the velocity step happens
        # lazily at the particle's NEXT suggest — tune reports a score
        # every training iteration, and only the best of them should
        # drive the swarm (not iteration-1 noise).
        self._pending: Dict[Tuple, List[int]] = {}
        self._assigned: Dict[int, Tuple] = {}      # particle -> active key
        self._obs = np.full(self.n_particles, np.nan)

    @staticmethod
    def _key(cfg: Dict[str, Any]) -> Tuple:
        return tuple(sorted((k, repr(v)) for k, v in cfg.items()))

    def _step_particle(self, i: int) -> None:
        """Apply the completed suggestion's best score, then move."""
        s = self._obs[i]
        if np.isnan(s):
            return                      # errored/unreported trial: no move
        if s > self.pbest_score[i]:
            self.pbest_score[i] = s
            self.pbest[i] = self.x[i].copy()
        if s > self.gbest_score:
            self.gbest_score = s
            self.gbest = self.x[i].copy()
        r1 = self.np_rng.uniform(size=self.x[i].shape)
        r2 = self.np_rng.uniform(size=self.x[i].shape)
        self.v[i] = (self.w * self.v[i]
                     + self.c1 * r1 * (self.pbest[i] - self.x[i])
                     + self.c2 * r2 * (self.gbest - self.x[i]))
        self.v[i] = np.clip(self.v[i], -self.v_max, self.v_max)
        self.x[i] = np.clip(self.x[i] + self.v[i], 0.0, 1.0)

    def suggest(self):
        i = self._next % self.n_particles
        self._next += 1
        self._step_particle(i)
        # retire the previous suggestion's routing entry for this particle
        old = self._assigned.pop(i, None)
        if old is not None:
            fifo = self._pending.get(old, [])
            if i in fifo:
                fifo.remove(i)
            if not fifo:
                self._pending.pop(old, None)
        cfg = _decode_vector(self.x[i], self._cols, self._consts)
        key = self._key(cfg)
        self._pending.setdefault(key, []).append(i)
        self._assigned[i] = key
        self._obs[i] = np.nan
        return cfg

    def observe(self, config, score, budget=None):
        s = float(score)
        if self.mode == "min":
            s = -s
        fifo = self._pending.get(self._key(config))
        if not fifo:
            return                      # observation from another searcher
        # every pending particle with this key proposed the identical
        # config, so the result is a valid evaluation for each of them
        for i in fifo:
            self._obs[i] = (s if np.isnan(self._obs[i])
                            else max(self._obs[i], s))
