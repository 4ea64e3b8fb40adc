"""OverSketched Newton (paper Alg. 3 / Alg. 4): the master loop; port of
``repro/core/newton.py``.

Each iteration:

  1. gradient  - exact and straggler-resilient through the 2-D product-coded
     matvecs of Alg. 1 (``CodedMatvecEngine``); on a CUDA device the
     workers' block products go through the coded block mat-vec kernel;
  2. Hessian   - approximate and straggler-resilient through the blocks of
     a sketch family (Alg. 2, ``_hessian_phase``); with ``use_kernels`` on
     a CUDA device it runs the family's fused sketch -> Gram kernel;
  3. direction - Cholesky/CG or pinv/MINRES (``_solve_direction``),
     optionally Marchenko-Pastur debiased (``debias``).  With
     ``sketch_mode="distributed-avg"`` steps 2-3 are instead one solve per
     surviving sketch block and the average of the (debiased) directions
     (``_distavg_direction_phase``, Bartan-Pilanci 2020);
  4. step size - the Armijo (Eq. 5) or gradient-norm (Eq. 6) line search.

Every phase is timed and billed by the simulated fleet (``SimClock``), on
the host.  When a phase exhausts its retry budget (``fail_open=False``)
the loop degrades as the reference does unless ``fault_fallback="raise"``.
The tensors live on the entry point's device: CUDA unless the caller
passes ``device="cpu"``.

A fleet that corrupts coded products (a fault plan's ``CorruptionSpec``, or
a replayed trace whose rows carry corruption) is decoded around by parity
checks (``corruption_detection``, on by default; off trusts the arrived
bytes).  ``adaptive_sketch`` doubles the sketch dimension when progress
stalls or the surviving rows' Marchenko-Pastur factor falls below
``adaptive_mp_target``.  A clock with an ``obs.Telemetry`` attached gets
the run and iteration spans, the loop's gauges and counters and each
iteration's critical path, as the reference emits them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, prng, resolve_device, scheduler, sketching
from repro_torch.core import coded, linesearch, solvers, straggler
from repro_torch.core.objectives import Dataset
from repro_torch.core.sketch import OverSketchConfig
from repro_torch.kernels import ops as kops
from repro_torch.runtime.faults import PhaseExhaustedError


def _telemetry(clock) -> "obs.Telemetry":
    """The clock's attached telemetry, or the no-op."""
    return clock.telemetry if clock is not None else obs.NULL


def _decodable(erased_grid: np.ndarray) -> bool:
    """Host-side peeling feasibility on the (g+1)x(g+1) erasure grid: a
    line with exactly one missing cell can be recovered; iterate."""
    known = ~erased_grid.copy()
    for _ in range(2 * known.shape[0]):
        if known.all():
            return True
        progress = False
        for axis in (0, 1):
            missing = (~known).sum(axis=axis)
            for i in np.where(missing == 1)[0]:
                if axis == 0:
                    known[int(np.argmin(known[:, i])), i] = True
                else:
                    known[i, int(np.argmin(known[i, :]))] = True
                progress = True
        if not progress:
            return False
    return bool(known.all())


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """The reference's configuration, field for field, so one config means
    the same in both packages (see the module docstring for what the port
    checks)."""

    iters: int = 20
    sketch: OverSketchConfig = dataclasses.field(
        default_factory=lambda: OverSketchConfig(
            sketch_dim=2048, block_size=256, straggler_tolerance=0.25))
    beta: float = 0.1
    candidates: tuple = linesearch.DEFAULT_CANDIDATES
    unit_step: bool = False
    solver: str = "auto"            # auto | chol | cg | pinv | minres
    cg_iters: int = 64
    gradient_policy: str = "coded"  # coded | wait_all | ignore | speculative | exact
    hessian_policy: str = "oversketch"   # oversketch | exact | exact_speculative
    sketch_family: str = "oversketch"
    debias: bool = False
    sketch_mode: str = "blocks"
    distavg_solver: str = "chol"
    coded_block_rows: int = 256
    overlap_encode: bool = True
    schedule: str = "dag"           # dag | sequential
    phase_memory: bool = False
    seed: int = 0
    use_kernels: bool = False       # route the Hessian through the kernels
    track_test_error: bool = False
    adaptive_sketch: bool = False
    adaptive_stall_ratio: float = 0.25
    adaptive_max_growth: int = 4
    adaptive_metric: str = "stall"
    adaptive_mp_target: float = 0.75
    fault_fallback: str = "degrade"
    survivor_floor: float = 0.5
    corruption_detection: bool = True


@dataclasses.dataclass
class NewtonResult:
    w: torch.Tensor
    history: Dict[str, List[float]]


def _phase_mem(enabled: bool, working_set_bytes: float) -> Optional[float]:
    """Declared Lambda size for a phase, or None for the fleet-wide 3 GB."""
    return scheduler.lambda_memory_gb(working_set_bytes) if enabled else None


def _ws_gb(working_set_bytes: float) -> float:
    return float(working_set_bytes) / 2.0 ** 30


class CodedMatvecEngine:
    """Holds the one-time 2-D product-code encodings of X and X^T and serves
    straggler-resilient matvecs.  Each operand's encode is billed as a
    fleet phase on first use; with ``overlap_encode`` both encodes launch
    when the engine comes up and the later one hides behind the compute
    dispatched since (Sec. 4.1).

    ``paranoid`` latches on the first observed corruption (a parity flag
    or a rejected decode): from then on a coded phase waits for every
    worker, where the row x column intersection localizes corruption and
    verification catches what cancels, so each later matvec is exact or a
    billed relaunch."""

    def __init__(self, data: Dataset, block_rows: int,
                 model: Optional[straggler.StragglerModel],
                 overlap_encode: bool = True, phase_memory: bool = False,
                 corruption_detection: bool = True):
        self.model = model
        self.overlap_encode = overlap_encode
        self.phase_memory = phase_memory
        self.corruption_detection = corruption_detection
        self._encode_pending = {"X", "XT"}
        self._encode_t0: Optional[float] = None
        n, d = data.x.shape
        self.code_x = coded.make_code(n, max(1, min(block_rows, n)))
        self.code_xt = coded.make_code(d, max(1, min(block_rows, d)))
        self.enc_x = coded.encode_2d(data.x, self.code_x)
        self.enc_xt = coded.encode_2d(data.x.T, self.code_xt)
        self.out_rows = {"X": n, "XT": d}
        self.fallbacks = 0
        self.paranoid = False

    def code_for(self, tag: str) -> coded.ProductCode:
        return self.code_x if tag == "X" else self.code_xt

    def _mv(self, tag: str, v: torch.Tensor,
            erased: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        enc = self.enc_x if tag == "X" else self.enc_xt
        return coded.coded_matvec(enc, v, self.code_for(tag),
                                  self.out_rows[tag], erased)

    def matvec(self, tag: str, v: torch.Tensor, clock: straggler.SimClock,
               key: torch.Tensor, policy: str,
               dag: Optional[scheduler.DagRun] = None,
               name: Optional[str] = None,
               after: Tuple[str, ...] = ()) -> torch.Tensor:
        """One straggler-resilient coded matvec.  With ``dag`` the compute
        phase (and, on decode failure, the retry phase) is a named DAG node
        with deps ``after``."""
        code = self.code_for(tag)
        w = code.num_workers
        enc = self.enc_x if tag == "X" else self.enc_xt
        flops = 2.0 * code.block_rows * enc.shape[-1]   # one block matvec
        mem_bytes = scheduler.matvec_worker_bytes(code.block_rows,
                                                  enc.shape[-1])
        mem = _phase_mem(self.phase_memory, mem_bytes)
        ws = _ws_gb(mem_bytes)
        enc_floor = None     # set if this call bills an encode phase

        def phase(k, policy, *, kk=None, decodable=None):
            try:
                if dag is not None:
                    # The compute phase consumes this operand's encode:
                    # floor its launch at the encode's finish.
                    res = dag.dispatch(scheduler.PhaseSpec(
                        name=name or tag, workers=w, policy=policy, k=kk,
                        flops_per_worker=flops, comm_units=1.0,
                        memory_gb=mem, working_set_gb=ws,
                        decodable=decodable, deps=after),
                        key=k, min_start=enc_floor)
                    return res.mask
                return clock.phase(k, w, policy=policy, k=kk,
                                   flops_per_worker=flops, comm_units=1.0,
                                   decodable=decodable, memory_gb=mem,
                                   working_set_gb=ws,
                                   phase_name=name or tag)[1]
            except PhaseExhaustedError as e:
                # The retry budget ran out mid-phase (attempts billed,
                # clock advanced): degrade to whatever arrived; the coded
                # path treats the dead workers as erasures.
                _telemetry(clock).metrics.counter(
                    "coded.exhausted_phases").inc()
                return torch.from_numpy(e.mask)

        if self.model is not None and tag in self._encode_pending:
            # One-time product-code encode of this operand, billed on first
            # use; launching "now" overlaps nothing, so it then takes the
            # sequential path (bit-identical clock).
            self._encode_pending.discard(tag)
            if self._encode_t0 is None:
                self._encode_t0 = clock.time
            nb = self._encode_t0 if self.overlap_encode else None
            if nb is not None and nb == clock.time:
                nb = None
            try:
                clock.phase(prng.fold_in(key, 555), w, policy="wait_all",
                            flops_per_worker=float(code.block_rows
                                                   * enc.shape[-1]),
                            comm_units=1.0, not_before=nb, memory_gb=mem,
                            working_set_gb=ws, phase_name=f"encode:{tag}")
            except PhaseExhaustedError:
                # Attempts billed, budget gone: the master re-runs the
                # cheap parity sums locally; only the round is lost.
                _telemetry(clock).metrics.counter(
                    "coded.exhausted_phases").inc()
            enc_floor = clock.time
        erased = None
        corrupt = None
        g1 = code.grid + 1
        if self.model is not None and policy == "coded":
            if self.paranoid and self.corruption_detection:
                mask = phase(key, "wait_all")
            else:
                # Decode starts as soon as the arrived set is peelable
                # (Alg. 1 step 8): the coded_decode policy with the
                # peeling predicate.
                k_min = max(1, w - (2 * code.grid + 1))
                mask = phase(key, "coded_decode", kk=k_min,
                             decodable=lambda m: _decodable(
                                 ~m.reshape(g1, g1)))
            arrived = mask.numpy()
            erased = (~mask).reshape(g1, g1).to(v.device)
            lc = clock.last_corruption
            if lc is not None:
                # Arrived results the fault plane flagged as corrupted;
                # the rate is set even when 0, the monitors' baseline.
                corrupt = np.asarray(lc) & arrived
                tel = _telemetry(clock)
                if tel.enabled:
                    tel.metrics.gauge("coded.block_error_rate").set(
                        float(corrupt.sum()) / float(w))
        elif self.model is not None and policy in ("wait_all", "speculative"):
            phase(key, policy)
        elif self.model is not None and policy == "ignore":
            # mini-batch style: pay the k-of-n time, use the exact product.
            phase(key, "k_of_n", kk=max(1, int(0.95 * w)))
        if corrupt is not None and corrupt.any():
            y, ok = self._corrupted_decode(tag, v, key, clock, corrupt,
                                           arrived)
        else:
            y, ok = self._mv(tag, v, erased)
        if erased is not None and not bool(ok):
            # Erasure pattern beyond the code, or a rejected decode: the
            # master re-launches the stragglers; charge a full round.
            self.fallbacks += 1
            y, _ = self._mv(tag, v, None)
            _telemetry(clock).metrics.counter("coded.decode_fallbacks").inc()
            kf = prng.fold_in(key, 1)
            try:
                if dag is not None and (name or tag) in dag.results:
                    dag.dispatch(scheduler.PhaseSpec(
                        name=(name or tag) + "/retry", workers=w,
                        policy="wait_all", comm_units=1.0, memory_gb=mem,
                        working_set_gb=ws, deps=((name or tag),)), key=kf)
                else:
                    clock.phase(kf, w, policy="wait_all", comm_units=1.0,
                                memory_gb=mem, working_set_gb=ws,
                                phase_name=(name or tag) + "/retry")
            except PhaseExhaustedError:
                # The relaunch round exhausted too: its attempts are
                # billed, and the master already recomputed y above.
                _telemetry(clock).metrics.counter(
                    "coded.exhausted_phases").inc()
        return y

    def _corrupted_decode(self, tag: str, v: torch.Tensor, key: torch.Tensor,
                          clock: straggler.SimClock, corrupt: np.ndarray,
                          arrived: np.ndarray
                          ) -> Tuple[torch.Tensor, object]:
        """Decode what the master received: every worker's clean product
        plus seeded noise at the corrupted cells.  The noise scale is the
        RMS over the whole grid, erased cells included (so the products are
        rebuilt with none erased).  Returns (y, ok); with detection a
        rejected decode gives zeros and ok False (the caller relaunches)."""
        code = self.code_for(tag)
        g1 = code.grid + 1
        enc = self.enc_x if tag == "X" else self.enc_xt
        prods = coded.coded_block_products(enc, v)
        noise = (torch.sqrt(torch.mean(prods ** 2)) + 1e-30) * kops.normal(
            prng.fold_in(key, 777), tuple(prods.shape), device=prods.device)
        cgrid = torch.from_numpy(corrupt.reshape(g1, g1)).to(prods.device)
        prods = torch.where(cgrid[..., None], prods + noise, prods)
        known = torch.from_numpy(arrived.reshape(g1, g1)).to(prods.device)
        tel = _telemetry(clock)
        if tel.enabled:
            tel.metrics.counter("coded.corruption_injected").inc(
                int(corrupt.sum()))
        if not self.corruption_detection:
            return coded.decode_matvec(prods, known, code, self.out_rows[tag])
        # Parity checks demote localizable corruption to erasures; the
        # codeword verification rejects what slipped through.
        y, ok, n_flagged = coded.verified_decode(prods, known, code,
                                                 self.out_rows[tag])
        if tel.enabled and n_flagged:
            tel.metrics.counter("coded.corruption_detected").inc(n_flagged)
        if (n_flagged or not ok) and not self.paranoid:
            self.paranoid = True
            if tel.enabled:
                tel.metrics.counter("coded.paranoid_mode").inc()
        if y is None:
            y = torch.zeros((self.out_rows[tag],), dtype=prods.dtype,
                            device=prods.device)
        return y, ok


def _solve_direction(objective, h_hat: torch.Tensor, g: torch.Tensor,
                     cfg: NewtonConfig) -> torch.Tensor:
    solver = cfg.solver
    if solver == "auto":
        solver = "chol" if objective.strongly_convex else "pinv"
    if solver == "chol":
        return -solvers.psd_solve(h_hat, g)
    if solver == "cg":
        return -solvers.conjugate_gradient(lambda v: h_hat @ v, g,
                                           torch.zeros_like(g), cfg.cg_iters)
    if solver == "pinv":
        return -solvers.psd_pinv_solve(h_hat, g)
    if solver == "minres":
        return -solvers.minres(lambda v: h_hat @ v, g, cfg.cg_iters)
    raise ValueError(solver)


def _hessian_phase(objective, data: Dataset, w: torch.Tensor,
                   cfg: NewtonConfig, key: torch.Tensor,
                   clock: Optional[straggler.SimClock],
                   dag: Optional[scheduler.DagRun] = None,
                   tag: str = "hessian"
                   ) -> Tuple[Optional[torch.Tensor], Optional[float]]:
    """Returns (H_hat including hess_reg * I, surviving sketch rows m_eff;
    None on the exact path).  ``(None, None)`` means the sketch round (and
    its one re-dispatch) exhausted its retry budget with fewer than
    ``survivor_floor`` of the blocks: the caller takes a gradient step.

    A sketched Hessian invokes (N+e) block workers, each output tile
    waiting for any N of them (Alg. 2); the exact one ceil(n/b) (d/b)^2
    workers.  With ``dag`` the phase is a root node, concurrent with the
    gradient round; the phase key is the same either way, so the survivor
    mask and the iterate do not depend on the schedule."""
    a = objective.hess_sqrt(w, data)
    n_rows, d = a.shape
    b = max(cfg.sketch.block_size, 1)
    d_blocks = max(1, -(-d // b))

    def run(workers, policy, k=None, flops=0.0, comm=0.0, mem=None, ws=None,
            name=None, rkey=None, min_start=None):
        name = tag if name is None else name
        rkey = key if rkey is None else rkey
        if dag is not None:
            return dag.dispatch(scheduler.PhaseSpec(
                name=name, workers=workers, policy=policy, k=k,
                flops_per_worker=flops, comm_units=comm, memory_gb=mem,
                working_set_gb=ws), key=rkey, min_start=min_start).mask
        return clock.phase(rkey, workers, policy=policy, k=k,
                           flops_per_worker=flops, comm_units=comm,
                           memory_gb=mem, working_set_gb=ws,
                           phase_name=name)[1]

    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    if cfg.hessian_policy == "oversketch":
        scfg = cfg.sketch
        fam = sketching.get(cfg.sketch_family, scfg)
        survivors = torch.ones(scfg.total_blocks, dtype=torch.bool)
        if clock is not None:
            # Per output tile, any N of its N+e sketch-block workers; the
            # master I/O scales with the full worker count.
            total_workers = scfg.total_blocks * d_blocks * d_blocks
            mem_bytes = scheduler.sketch_worker_bytes(scfg.block_size,
                                                      min(d, b))
            kw = dict(k=scfg.num_blocks, flops=fam.block_flops(n_rows, d),
                      comm=fam.comm_units(d) * total_workers,
                      mem=_phase_mem(cfg.phase_memory, mem_bytes),
                      ws=_ws_gb(mem_bytes))
            try:
                survivors = run(scfg.total_blocks, "k_of_n", **kw)
            except PhaseExhaustedError as e:
                if cfg.fault_fallback == "raise":
                    raise
                _telemetry(clock).metrics.counter(
                    "newton.fault_fallbacks").inc()
                # Every block is unbiased on its own, so any survivor
                # subset is a thinner unbiased sketch: accept it when at
                # least survivor_floor of num_blocks landed.  Below the
                # floor re-dispatch the round once on fresh capacity; if
                # that exhausts too, the caller takes a gradient step.
                floor = max(1, math.ceil(cfg.survivor_floor
                                         * scfg.num_blocks))
                if int(e.mask.sum()) >= floor:
                    survivors = torch.from_numpy(e.mask)
                else:
                    try:
                        survivors = run(scfg.total_blocks, "k_of_n",
                                        name=tag + "/retry",
                                        rkey=prng.fold_in(key, 13),
                                        min_start=float(clock.time), **kw)
                    except PhaseExhaustedError as e2:
                        if int(e2.mask.sum()) < floor:
                            return None, None
                        survivors = torch.from_numpy(e2.mask)
        state = fam.sample(prng.fold_in(key, 7), n_rows, device=a.device)
        tel = _telemetry(clock)
        if tel.enabled:
            # The path the sketch -> Gram dispatch takes for this family
            # and d; the port's labels are "fused" and "unfused" only.
            path = fam.fused_path(d) if cfg.use_kernels else "unfused"
            tel.metrics.counter(f"kernel.path.{path}").inc()
        h_hat = fam.gram(state, a, survivors.to(a.device),
                         use_kernels=cfg.use_kernels)
        m_eff = float(survivors.sum()) * scfg.block_size
        if tel.enabled:
            tel.metrics.gauge("sketch.m_eff").set(m_eff)
            tel.metrics.gauge("sketch.mp_debias").set(
                max(0.0, 1.0 - d / m_eff) if m_eff > 0 else 0.0)
            tel.metrics.histogram("sketch.survivors").observe(
                float(survivors.sum()))
        return h_hat + objective.hess_reg * eye, m_eff
    # exact Hessian (the paper's "exact Newton" baseline)
    if clock is not None:
        workers = max(1, -(-n_rows // b)) * d_blocks * d_blocks
        policy = ("speculative" if cfg.hessian_policy == "exact_speculative"
                  else "wait_all")
        mem_bytes = scheduler.sketch_worker_bytes(b, min(d, b))
        try:
            run(workers, policy, flops=2.0 * b * min(d, b) ** 2,
                comm=0.05 * workers,
                mem=_phase_mem(cfg.phase_memory, mem_bytes),
                ws=_ws_gb(mem_bytes))
        except PhaseExhaustedError:
            if cfg.fault_fallback == "raise":
                raise
            # The exact product is deterministic: the master's local
            # recompute stands in for the lost round.
            _telemetry(clock).metrics.counter("newton.fault_fallbacks").inc()
    return a.T @ a + objective.hess_reg * eye, None


def _distavg_direction(objective, fam, a: torch.Tensor, g: torch.Tensor,
                       state, survivors: torch.Tensor,
                       cfg: NewtonConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every surviving block-worker solves its own sketched system; the
    master averages the (debiased, factor 1 - d/b) directions.  Also
    returns the masked average of H_k g for the weakly convex search."""
    d = a.shape[1]
    a_t = fam.apply(state, a, use_kernels=cfg.use_kernels)      # (K, b, d)
    eye = torch.eye(d, dtype=a_t.dtype, device=a_t.device)
    grams = a_t.transpose(1, 2) @ a_t + objective.hess_reg * eye
    if cfg.distavg_solver == "cg":
        p_k = -torch.stack([
            solvers.conjugate_gradient(lambda v, hk=hk: hk @ v, g,
                                       torch.zeros_like(g), cfg.cg_iters)
            for hk in grams])
    else:
        p_k = -solvers.psd_solve(grams, g)
    if cfg.debias:
        p_k = sketching.debias_direction(p_k, d, fam.cfg.block_size)
    m = survivors.to(device=a_t.device, dtype=a_t.dtype)
    n_avail = m.sum().clamp_min(1.0)
    p = m @ p_k / n_avail
    hg = torch.einsum("k,kde,e->d", m, grams, g) / n_avail
    return p, hg


def _distavg_direction_phase(objective, data: Dataset, w: torch.Tensor,
                             g: torch.Tensor, cfg: NewtonConfig,
                             key: torch.Tensor,
                             clock: Optional[straggler.SimClock],
                             dag: Optional[scheduler.DagRun] = None,
                             grad_dep: Optional[str] = None,
                             tag: str = "distavg"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sketch_mode="distributed-avg": one worker per sketch block, each
    paying its apply, d x d Gram and local solve; the master only receives
    d-vectors.  Returns (direction, averaged H_k g).

    With ``dag`` the round splits at its data dependency: the sketch phase
    (apply + per-block Gram, a function of w only) launches with the
    gradient round, and the solve phase (needs g) runs after both.  The
    survivor mask comes from the sketch phase, under the same key as the
    sequential combined phase."""
    a = objective.hess_sqrt(w, data)
    n_rows, d = a.shape
    scfg = cfg.sketch
    fam = sketching.get(cfg.sketch_family, scfg)
    survivors = torch.ones(scfg.total_blocks, dtype=torch.bool)
    if clock is not None:
        # No coded matmul to amortize into here, so a family that reports
        # apply_flops = 0 (oversketch) still pays one pass over A.
        apply_flops = fam.apply_flops(n_rows, d) or 2.0 * n_rows * d
        gram_flops = 2.0 * scfg.block_size * d * d
        solve_flops = (d ** 3 / 3.0 if cfg.distavg_solver == "chol"
                       else 2.0 * cfg.cg_iters * d * d)
        mem_bytes = scheduler.distavg_worker_bytes(scfg.block_size, d)
        mem = _phase_mem(cfg.phase_memory, mem_bytes)
        ws = _ws_gb(mem_bytes)
        try:
            if dag is not None:
                sk = dag.dispatch(scheduler.PhaseSpec(
                    name=f"{tag}-sketch", workers=scfg.total_blocks,
                    policy="k_of_n", k=scfg.num_blocks,
                    flops_per_worker=apply_flops + gram_flops,
                    comm_units=0.01 * scfg.total_blocks, memory_gb=mem,
                    working_set_gb=ws), key=key)
                survivors = sk.mask
                # An exhausted gradient phase never registered with the
                # DAG: keep only edges to phases that exist, and let the
                # barrier at the current clock stand in for the missing one.
                want = (f"{tag}-sketch",) + \
                    ((grad_dep,) if grad_dep is not None else ())
                deps = tuple(dd for dd in want if dd in dag.results)
                dag.dispatch(scheduler.PhaseSpec(
                    name=f"{tag}-solve", workers=scfg.num_blocks,
                    policy="wait_all", flops_per_worker=solve_flops,
                    comm_units=0.01 * scfg.num_blocks, memory_gb=mem,
                    working_set_gb=ws, deps=deps),
                    key=prng.fold_in(key, 11),
                    sequential=len(deps) < len(want))
            else:
                survivors = clock.phase(
                    key, scfg.total_blocks, policy="k_of_n",
                    k=scfg.num_blocks,
                    flops_per_worker=apply_flops + gram_flops + solve_flops,
                    comm_units=0.01 * scfg.total_blocks, memory_gb=mem,
                    working_set_gb=ws, phase_name=tag)[1]
        except PhaseExhaustedError as e:
            if cfg.fault_fallback == "raise":
                raise
            # The finite finishers stand in for the k-of-n survivors (each
            # block's direction is unbiased on its own); the caller's
            # descent guard backstops a round with no survivor.
            _telemetry(clock).metrics.counter("newton.fault_fallbacks").inc()
            if e.mask.shape == (scfg.total_blocks,):
                survivors = torch.from_numpy(e.mask)
    state = fam.sample(prng.fold_in(key, 7), n_rows, device=a.device)
    return _distavg_direction(objective, fam, a, g, state, survivors, cfg)


def _check_config(cfg: NewtonConfig, d: int) -> None:
    """Refuse what the reference refuses (d: the Hessian's dimension)."""
    if cfg.sketch_mode not in ("blocks", "distributed-avg"):
        raise ValueError(f"unknown sketch_mode {cfg.sketch_mode!r}")
    if cfg.distavg_solver not in ("chol", "cg"):
        raise ValueError(f"unknown distavg_solver {cfg.distavg_solver!r}")
    if cfg.schedule not in ("dag", "sequential"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.adaptive_metric not in ("stall", "mp"):
        raise ValueError(f"unknown adaptive_metric {cfg.adaptive_metric!r}")
    if cfg.fault_fallback not in ("degrade", "raise"):
        raise ValueError(f"unknown fault_fallback {cfg.fault_fallback!r}")
    if cfg.hessian_policy not in ("oversketch", "exact", "exact_speculative"):
        raise ValueError(f"unknown hessian_policy {cfg.hessian_policy!r}")
    if not 0.0 < cfg.survivor_floor <= 1.0:
        raise ValueError(
            f"survivor_floor must be in (0, 1], got {cfg.survivor_floor}")
    if (cfg.adaptive_sketch and cfg.adaptive_metric == "mp"
            and (cfg.sketch_mode != "blocks"
                 or cfg.hessian_policy != "oversketch")):
        raise ValueError(
            "adaptive_metric='mp' needs the surviving sketch-row count, "
            "which only the sketch_mode='blocks' + "
            "hessian_policy='oversketch' path reports")
    if cfg.sketch_mode == "distributed-avg":
        if cfg.hessian_policy != "oversketch":
            raise ValueError(
                "sketch_mode='distributed-avg' requires "
                f"hessian_policy='oversketch', got {cfg.hessian_policy!r}")
        if cfg.sketch.block_size <= d:
            raise ValueError(
                "distributed-avg needs block_size > Hessian dim for the "
                f"per-worker solves to be well-posed: block_size="
                f"{cfg.sketch.block_size} <= d={d}")
    sketching.get(cfg.sketch_family, cfg.sketch)   # fail fast on bad family


def oversketched_newton(objective, data: Dataset, w0, cfg: NewtonConfig,
                        model=straggler.StragglerModel(),
                        device=None) -> NewtonResult:
    """Run OverSketched Newton; returns the iterate and a per-iteration log
    (``iter``, ``fval``, ``gnorm``, ``step``, simulated ``time`` and
    ``cost``, ``test_error``, ``sketch_dim``, and the port's own
    ``wall_s``: host seconds per iteration).

    ``model`` is a ``StragglerModel`` (a fresh fleet clock is built), a
    prebuilt ``SimClock``, or None (no fleet: exact gradients, unit
    clock).  Runs on CUDA unless ``device`` says otherwise; the dataset and
    ``w0`` are moved there."""
    device = resolve_device(device)
    _check_config(cfg, torch.as_tensor(w0).numel())
    data = Dataset(*(None if t is None else t.to(device) for t in data))
    key = prng.PRNGKey(cfg.seed)
    if isinstance(model, straggler.SimClock):
        clock, model = model, model.model
    else:
        clock = straggler.SimClock(model) if model is not None else None
    coded_gradient = cfg.gradient_policy != "exact" and model is not None
    engine = (CodedMatvecEngine(data, cfg.coded_block_rows, model,
                                overlap_encode=cfg.overlap_encode,
                                phase_memory=cfg.phase_memory,
                                corruption_detection=cfg.corruption_detection)
              if coded_gradient else None)

    w = torch.as_tensor(w0, dtype=torch.float32).to(device)
    hist: Dict[str, List[float]] = {k: [] for k in (
        "iter", "fval", "gnorm", "step", "time", "cost", "test_error",
        "sketch_dim", "wall_s")}
    live_cfg = cfg
    init_sketch_dim = cfg.sketch.sketch_dim   # the growth cap's baseline
    prev_f = None
    prev_decrease = None

    tel = _telemetry(clock)
    run_span = tel.trace.begin(
        "newton", "run", clock.time if clock is not None else 0.0,
        sketch_family=cfg.sketch_family, schedule=cfg.schedule,
        sketch_mode=cfg.sketch_mode)
    if tel.enabled and cfg.solver in ("cg", "minres"):
        tel.metrics.gauge("newton.cg_iters").set(cfg.cg_iters)

    for t in range(cfg.iters):
        cfg = live_cfg
        t_wall = time.perf_counter()
        key, kg, kh, kl = prng.split(key, 4)
        it_span = tel.trace.begin(
            f"iter{t}", "iteration",
            clock.time if clock is not None else float(t))
        # One iteration = one phase DAG: gradient matvecs chain through
        # edges, the Hessian sketch is a root node, the line search joins
        # both.  The phase keys, hence masks and iterates, do not depend on
        # the schedule.
        dag = (scheduler.DagRun(clock, key=key)
               if cfg.schedule == "dag" and clock is not None else None)

        # --- 1. gradient (straggler-resilient coded matvecs, Alg. 1) ------
        grad_tail = None
        if not coded_gradient:
            g = objective.gradient(w, data)
        else:
            mv_seq = [0]

            def mv(tag, v):
                kf = prng.fold_in(kg, {"X": 3, "XT": 5}[tag])
                if dag is None:
                    return engine.matvec(tag, v, clock, kf,
                                         cfg.gradient_policy)
                after = (dag.last,) if dag.last is not None else ()
                y = engine.matvec(tag, v, clock, kf, cfg.gradient_policy,
                                  dag=dag, name=f"grad/{mv_seq[0]}:{tag}",
                                  after=after)
                mv_seq[0] += 1
                return y

            g = objective.gradient_via(w, data, mv)
            if dag is not None:
                grad_tail = dag.last

        # --- 2+3. sketched Hessian (Alg. 2) and direction -----------------
        m_eff = None
        if cfg.sketch_mode == "distributed-avg":
            p, hg = _distavg_direction_phase(objective, data, w, g, cfg, kh,
                                             clock, dag=dag,
                                             grad_dep=grad_tail)
        else:
            h_hat, m_eff = _hessian_phase(objective, data, w, cfg, kh, clock,
                                          dag=dag)
            if h_hat is None:
                # The sketch round and its re-dispatch lost too many
                # blocks: a gradient step, with hg = g (H = I) keeping the
                # weakly convex search coherent.
                p, hg = -g, g
                tel.metrics.counter("newton.gradient_fallbacks").inc()
            else:
                p = _solve_direction(objective, h_hat, g, cfg)
                if cfg.debias and m_eff is not None:
                    p = sketching.debias_direction(p, p.shape[0], m_eff)
                hg = None

        # Descent guard: only a finite descent direction reaches the line
        # search; anything else degrades to steepest descent.
        gp = float(g @ p)
        if not math.isfinite(gp) or gp >= 0.0:
            p, hg = -g, g
            tel.metrics.counter("newton.safeguard_fallbacks").inc()

        # --- 4. distributed line search (Sec. 3.2) -------------------------
        if cfg.unit_step:
            step = torch.ones((), device=device)
        elif objective.strongly_convex:
            step = linesearch.linesearch_strongly_convex(
                objective, data, w, p, g, cfg.beta, cfg.candidates)
        else:
            if hg is None:
                hg = h_hat @ g
            step = linesearch.linesearch_weakly_convex(
                objective, data, w, p, g, hg, cfg.beta, cfg.candidates)
        if clock is not None and not cfg.unit_step:
            nb = max(1, data.x.shape[0] // max(cfg.coded_block_rows, 1))
            ls_flops = (2.0 * cfg.coded_block_rows * data.x.shape[1]
                        * len(cfg.candidates))
            ls_bytes = scheduler.matvec_worker_bytes(cfg.coded_block_rows,
                                                     data.x.shape[1])
            ls_mem = _phase_mem(cfg.phase_memory, ls_bytes)
            try:
                if dag is not None:
                    # The line search consumes every phase so far; the clock
                    # already sits at the DAG's frontier, so it dispatches
                    # on the sequential path with its edges declared.
                    dag.dispatch(scheduler.PhaseSpec(
                        name="linesearch", workers=nb, policy="wait_all",
                        flops_per_worker=ls_flops, comm_units=0.5,
                        memory_gb=ls_mem, working_set_gb=_ws_gb(ls_bytes),
                        deps=tuple(dag.results)), key=kl, sequential=True)
                else:
                    clock.phase(kl, nb, policy="wait_all",
                                flops_per_worker=ls_flops, comm_units=0.5,
                                memory_gb=ls_mem,
                                working_set_gb=_ws_gb(ls_bytes),
                                phase_name="linesearch")
            except PhaseExhaustedError:
                if cfg.fault_fallback == "raise":
                    raise
                # Billed and lost: the trial values are the master's own
                # arithmetic, so the chosen step stands.
                tel.metrics.counter("newton.fault_fallbacks").inc()

        w = w + step * p

        hist["iter"].append(t)
        f_now = float(objective.value(w, data))
        hist["fval"].append(f_now)
        hist["gnorm"].append(float(torch.linalg.norm(
            objective.gradient(w, data))))
        hist["step"].append(float(step))
        hist["time"].append(clock.time if clock is not None else float(t + 1))
        hist["cost"].append(clock.dollars if clock is not None else 0.0)
        hist["sketch_dim"].append(live_cfg.sketch.sketch_dim)

        if tel.enabled:
            tel.metrics.gauge("newton.sketch_dim").set(
                live_cfg.sketch.sketch_dim)
            # Per-iteration seconds and dollars: the streams the health
            # monitors watch for blowups.
            many = len(hist["time"]) > 1
            tel.metrics.gauge("newton.iter_seconds").set(
                hist["time"][-1] - (hist["time"][-2] if many else 0.0))
            tel.metrics.gauge("newton.iter_dollars").set(
                hist["cost"][-1] - (hist["cost"][-2] if many else 0.0))
            if cfg.solver in ("cg", "minres"):
                tel.metrics.gauge("newton.cg_iters").set(cfg.cg_iters)
            if dag is not None and dag.results:
                rep = dag.critical_path()
                tel.trace.set_attrs(
                    it_span,
                    critical_path=list(rep.critical_path),
                    dag_makespan=rep.makespan,
                    slack={n: ph.slack for n, ph in rep.phases.items()})
        tel.trace.end(it_span,
                      clock.time if clock is not None else float(t + 1))

        # --- adaptive sketch growth (paper Thm 3.2 remark) ----------------
        if cfg.adaptive_sketch:
            if cfg.adaptive_metric == "mp":
                # The measured MP factor of the surviving rows says the
                # sketch is too biased to trust: a leading indicator,
                # available from iteration 0.
                stalled = m_eff is not None and sketching.mp_stalled(
                    int(p.shape[0]), m_eff, cfg.adaptive_mp_target)
            elif prev_f is not None:
                decrease = prev_f - f_now
                # An increase in f is always a stall; otherwise progress
                # fell off against the last iteration's.
                stalled = decrease < 0 or (
                    prev_decrease is not None and prev_decrease > 0
                    and decrease < cfg.adaptive_stall_ratio * prev_decrease)
            else:
                stalled = False
            grown = live_cfg.sketch.sketch_dim // init_sketch_dim
            if stalled and grown < cfg.adaptive_max_growth:
                live_cfg = dataclasses.replace(
                    live_cfg, sketch=dataclasses.replace(
                        live_cfg.sketch,
                        sketch_dim=live_cfg.sketch.sketch_dim * 2))
                tel.metrics.counter("newton.adaptive_growth").inc()
        if prev_f is not None:
            prev_decrease = prev_f - f_now
        prev_f = f_now
        if cfg.track_test_error and data.x_test is not None:
            hist["test_error"].append(
                float(objective.error(w, data.x_test, data.y_test)))
        else:
            hist["test_error"].append(float("nan"))
        # Host seconds of the iteration; the float() reads above wait for
        # the device, so this includes its work.
        hist["wall_s"].append(time.perf_counter() - t_wall)
    tel.trace.end(run_span,
                  clock.time if clock is not None else float(cfg.iters))
    return NewtonResult(w=w, history=hist)
