"""α–β cost model of the allreduce decompositions, and the tuning cache.

Counterpart of ``horovod_tpu/utils/costs.py``, with the two link levels
renamed: ``nvlink`` (intra-host, the reference's ``ici``) and ``ib``
(cross-host, its ``dcn``). A collective over S bytes costs

    t = n_phases · α_level  +  traffic_factor · S / β_level

with the bottleneck level's constants. For group size n, ``L`` ranks a
host and ``M`` hosts (n = L·M):

* ``flat``          1 phase, ring factor ``2(n-1)/n``; the bottleneck is
                    InfiniBand once the ring crosses hosts, else NVLink.
* ``rs_ag``         2 phases of ``(n-1)/n · S``; the all-gather phase is
                    charged ``1 − RS_AG_OVERLAP`` of its bandwidth term (the
                    overlap with neighbouring buckets rs_ag exists for).
* ``hierarchical``  reduce-scatter and all-gather over NVLink at
                    ``(L-1)/L · S`` each; only the 1/L shard crosses
                    InfiniBand (``2(M-1)/M · S/L``).

Constants are the topology's seeds (``ops/topology.py``) unless a tuning
cache (``HOROVOD_TUNING_CACHE``) of this layout's schema names this device
kind; a cache of another schema is ignored, never misread. ``auto``
choices only lower differently: every algorithm computes the same sum.
"""

from __future__ import annotations

import dataclasses
import json
import os

from horovod_tpu_torch.ops.topology import Link, Topology
from horovod_tpu_torch.utils import env as _env

# The port's own layout (the reference's v3, levels nvlink/ib); a file of
# any other schema is ignored.
SCHEMA = "horovod_tpu_torch/allreduce-tuning/v3"

ALGORITHMS = ("flat", "rs_ag", "hierarchical")

# Per-extra-channel efficiency seeds: C concurrent channel instances of one
# collective reach an aggregate bandwidth multiplier eta(C) = 1 +
# (C-1)*ch_eff on their level (1 = perfect scaling, 0 = no gain). The
# reference's seeds, conservative enough to keep small buckets at C=1.
CHANNEL_EFF_SEED = {"nvlink": 0.7, "ib": 0.85}

# Share of the all-gather phase assumed hidden behind neighbouring buckets.
RS_AG_OVERLAP = 0.5


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-level α–β constants and where they came from (``source``:
    ``"analytic"`` seeds or ``"calibrated"`` cache)."""

    nvlink: Link
    ib: Link
    source: str = "analytic"
    nvlink_ch_eff: float = CHANNEL_EFF_SEED["nvlink"]
    ib_ch_eff: float = CHANNEL_EFF_SEED["ib"]

    def channel_eta(self, level: str, channels: int) -> float:
        """Aggregate-bandwidth multiplier of ``channels`` concurrent
        instances on ``level`` (``"nvlink"``/``"ib"``)."""
        if channels <= 1:
            return 1.0
        eff = self.nvlink_ch_eff if level == "nvlink" else self.ib_ch_eff
        return 1.0 + (channels - 1) * max(0.0, min(1.0, eff))

    def predict_us(self, algo: str, nbytes: int, topo: Topology, *,
                   cross_nbytes: int | None = None,
                   gather: bool = False,
                   channels: int = 1) -> float:
        """Predicted µs of one ``algo`` allreduce of ``nbytes`` wire bytes
        over ``topo``; ``inf`` where the topology cannot run it. For
        ``hierarchical``, ``cross_nbytes`` is what the cross-host hop moves
        (None = ``nbytes``). ``gather``: an unsummable wire (int4), whose
        flat form is an all-gather (factor ``n-1``). ``channels``: each
        instance pays its α; the bandwidth term divides by
        :meth:`channel_eta`; hierarchical levels pipeline across
        channels."""
        n = topo.group_size
        channels = max(1, int(channels))
        if n <= 1:
            return 0.0
        s_us_per_byte_nvlink = 1e-3 / self.nvlink.gbps
        s_us_per_byte_ib = 1e-3 / self.ib.gbps
        level = "ib" if topo.multi_slice else "nvlink"
        bottleneck = s_us_per_byte_ib if topo.multi_slice \
            else s_us_per_byte_nvlink
        alpha = self.ib.alpha_us if topo.multi_slice \
            else self.nvlink.alpha_us
        eta = self.channel_eta(level, channels)
        ring = 2 * (n - 1) / n
        if algo == "flat":
            factor = (n - 1) if gather else ring
            return channels * alpha + factor * nbytes * bottleneck / eta
        if algo == "rs_ag":
            phase = (n - 1) / n * nbytes * bottleneck / eta
            return (2 * channels * alpha
                    + phase + (1 - RS_AG_OVERLAP) * phase)
        if algo == "hierarchical":
            if not topo.multi_slice or topo.local_size is None \
                    or topo.local_size < 2:
                return float("inf")
            L, M = topo.local_size, topo.num_slices
            cross_b = nbytes if cross_nbytes is None else cross_nbytes
            eta_nvlink = self.channel_eta("nvlink", channels)
            eta_ib = self.channel_eta("ib", channels)
            intra = 2 * (channels * self.nvlink.alpha_us
                         + (L - 1) / L * nbytes * s_us_per_byte_nvlink
                         / eta_nvlink)
            cross = (channels * self.ib.alpha_us
                     + 2 * (M - 1) / M * (cross_b / L) * s_us_per_byte_ib
                     / eta_ib)
            if channels <= 1:
                return intra + cross
            return max(intra, cross) + min(intra, cross) / channels
        raise ValueError(f"unknown allreduce algorithm {algo!r}")

    def choose(self, nbytes: int, topo: Topology, *,
               phase_nbytes: tuple[int, int] | None = None,
               gather: bool = False) -> str:
        """Cheapest feasible algorithm for one bucket; ties go to
        ``flat``. ``phase_nbytes``: ``(intra, cross)`` bytes of the
        phase-asymmetric hierarchical candidate."""
        best, best_t = "flat", float("inf")
        for algo in ALGORITHMS:
            if algo == "hierarchical" and phase_nbytes is not None:
                t = self.predict_us(algo, phase_nbytes[0], topo,
                                    cross_nbytes=phase_nbytes[1])
            else:
                t = self.predict_us(algo, nbytes, topo,
                                    gather=gather and algo == "flat")
            if t < best_t:
                best, best_t = algo, t
        return best

    def choose_channels(self, algo: str, nbytes: int, topo: Topology,
                        max_channels: int, *,
                        cross_nbytes: int | None = None,
                        gather: bool = False) -> int:
        """Cheapest power-of-two channel count <= ``max_channels`` for one
        bucket under ``algo``; ties go to fewer channels."""
        if max_channels <= 1 or topo.group_size <= 1 \
                or algo not in ALGORITHMS:
            return 1
        best, best_t = 1, float("inf")
        c = 1
        while c <= max_channels:
            t = self.predict_us(algo, nbytes, topo,
                                cross_nbytes=cross_nbytes, gather=gather,
                                channels=c)
            if t < best_t - 1e-12:
                best, best_t = c, t
            c <<= 1
        return best

    def predict_sparse_gather_us(self, payload_bytes: int, topo: Topology,
                                 n_phases: int = 2) -> float:
        """Predicted µs of one sparse gather exchange: every rank receives
        the other ``n-1`` ranks' ``payload_bytes`` over ``n_phases``
        collectives."""
        n = topo.group_size
        if n <= 1:
            return 0.0
        per_byte = (1e-3 / self.ib.gbps if topo.multi_slice
                    else 1e-3 / self.nvlink.gbps)
        alpha = self.ib.alpha_us if topo.multi_slice \
            else self.nvlink.alpha_us
        return n_phases * alpha + (n - 1) * payload_bytes * per_byte

    def choose_sparse(self, *, rows_per_rank: int, row_bytes: int,
                      dense_nbytes: int, dense_rows: int, topo: Topology,
                      density_threshold: float | None = None,
                      gather_phases: int = 2,
                      dense_gather: bool = False) -> str:
        """The sparse exchange's density switch: ``"gather"`` or
        ``"dense"``, whichever prices cheaper; ``density_threshold``
        (``HOROVOD_SPARSE_DENSITY_THRESHOLD``) overrides the model.
        1-rank groups always gather."""
        n = topo.group_size
        if n <= 1:
            return "gather"
        if density_threshold is not None:
            density = n * rows_per_rank / max(1, dense_rows)
            return "dense" if density >= density_threshold else "gather"
        t_gather = self.predict_sparse_gather_us(
            rows_per_rank * row_bytes, topo, n_phases=gather_phases)
        t_dense = self.predict_us("flat", dense_nbytes, topo,
                                  gather=dense_gather)
        return "gather" if t_gather <= t_dense else "dense"

    def sparse_crossover_density(self, row_bytes: int, dense_rows: int,
                                 dense_row_bytes: int, topo: Topology,
                                 gather_phases: int = 2) -> float:
        """The density at which the sparse gather and the dense flat
        allreduce price equal; ``inf`` when the gather never loses."""
        n = topo.group_size
        if n <= 1 or dense_rows <= 0 or row_bytes <= 0:
            return float("inf")
        per_byte = (1e-3 / self.ib.gbps if topo.multi_slice
                    else 1e-3 / self.nvlink.gbps)
        alpha = self.ib.alpha_us if topo.multi_slice \
            else self.nvlink.alpha_us
        t_dense = self.predict_us("flat", dense_rows * dense_row_bytes,
                                  topo)
        denom = (n - 1) / n * dense_rows * row_bytes * per_byte
        if denom <= 0:
            return float("inf")
        return max(0.0, (t_dense - gather_phases * alpha) / denom)

    def fusion_threshold_bytes(self, topo: Topology) -> int:
        """The bucket size at which an allreduce reaches 90% of its bus
        bandwidth, clamped to [1 MB, 256 MB]."""
        n = topo.group_size
        if n <= 1:
            return _env.DEFAULT_FUSION_THRESHOLD
        link = self.ib if topo.multi_slice else self.nvlink
        ring = 2 * (n - 1) / n
        s_star = 9 * link.alpha_us * link.gbps * 1e3 / ring  # bytes
        return int(min(max(s_star, 1 << 20), 256 << 20))


# -- the tuning cache -----------------------------------------------------------

_cache_memo: dict[tuple[str, int], dict | None] = {}


def load_tuning_cache(path: str | None = None) -> dict | None:
    """The parsed tuning cache, or None when absent, unreadable, or of
    another schema."""
    path = path or _env.tuning_cache_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    key = (os.path.abspath(path), mtime)
    if key in _cache_memo:
        return _cache_memo[key]
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        data = None
    if not isinstance(data, dict) or data.get("schema") != SCHEMA:
        data = None
    _cache_memo[key] = data
    return data


def save_tuning_cache(constants: dict, *, device_kind: str, world: int,
                      fusion_threshold: int | None = None,
                      measured: list | None = None,
                      recalibration: dict | None = None,
                      path: str | None = None) -> str:
    """Persist calibrated constants (``{"nvlink": {"alpha_us", "gbps"[,
    "ch_eff"]}, "ib": {...}}``; a level may be absent) atomically; returns
    the path."""
    path = path or _env.tuning_cache_path()
    data = {
        "schema": SCHEMA,
        "device_kind": device_kind,
        "world": world,
        "constants": constants,
    }
    if fusion_threshold is not None:
        data["fusion_threshold"] = int(fusion_threshold)
    if measured is not None:
        data["measured"] = measured
    if recalibration is not None:
        data["recalibration"] = recalibration
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2)
    os.replace(tmp, path)
    return path


def _link_from(entry, seed: Link) -> Link:
    """A calibrated level's Link, falling back to the seed field-wise."""
    if not isinstance(entry, dict):
        return seed
    try:
        alpha = float(entry.get("alpha_us", seed.alpha_us))
        gbps = float(entry.get("gbps", seed.gbps))
    except (TypeError, ValueError):
        return seed
    if alpha < 0 or gbps <= 0:
        return seed
    return Link(alpha_us=alpha, gbps=gbps)


def _ch_eff_from(entry, seed: float) -> float:
    if not isinstance(entry, dict):
        return seed
    try:
        eff = float(entry.get("ch_eff", seed))
    except (TypeError, ValueError):
        return seed
    if not 0.0 <= eff <= 1.0:
        return seed
    return eff


def model_from_constants(constants: dict | None, topo: Topology) -> CostModel:
    """A calibrated CostModel from a cache's ``constants``, the topology's
    seeds filling any level it lacks."""
    constants = constants or {}
    return CostModel(
        nvlink=_link_from(constants.get("nvlink"), topo.nvlink),
        ib=_link_from(constants.get("ib"), topo.ib),
        source="calibrated",
        nvlink_ch_eff=_ch_eff_from(constants.get("nvlink"),
                                   CHANNEL_EFF_SEED["nvlink"]),
        ib_ch_eff=_ch_eff_from(constants.get("ib"),
                               CHANNEL_EFF_SEED["ib"]))


def model_for(topo: Topology, path: str | None = None) -> CostModel:
    """The cost model for ``topo``: a valid cache's constants for this
    device kind, else the seeds."""
    cache = load_tuning_cache(path)
    if cache is None or cache.get("device_kind") != topo.device_kind:
        return CostModel(nvlink=topo.nvlink, ib=topo.ib, source="analytic")
    return model_from_constants(cache.get("constants"), topo)


def tuned_fusion_threshold(topo: Topology, path: str | None = None) -> int:
    """The cache's measured fusion threshold, else the analytic one."""
    cache = load_tuning_cache(path)
    if cache is not None and cache.get("device_kind") == topo.device_kind:
        raw = cache.get("fusion_threshold")
        if isinstance(raw, (int, float)) and raw > 0:
            return int(raw)
    return model_for(topo, path).fusion_threshold_bytes(topo)
