"""Krylov layer tests: convergence vs SciPy references, options plumbing,
preconditioner composition (the testbed solve surface, SURVEY.md §3.1)."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse.linalg as spla

from spike_petsc_tpu import (BandedMatrix, Options, make_pc, make_solver,
                             solve)
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.types import (CONVERGED_ATOL, CONVERGED_ITS,
                                           CONVERGED_RTOL, DIVERGED_ITS,
                                           reason_str)


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def manufactured(acsr, seed=None):
    """u = 1 (or random) exact solution, b = A u — the reference's
    manufactured-solution check (/root/reference/src/testbed.c:300-320)."""
    n = acsr.shape[0]
    if seed is None:
        u = np.ones(n)
    else:
        u = np.random.default_rng(seed).uniform(size=n)
    return u, acsr @ u


@pytest.mark.parametrize("ksp_type", ["gmres", "fgmres", "bcgs", "cg",
                                      "pipecg", "minres"])
def test_unpreconditioned_convergence_spd(ksp_type):
    a = problems.spd_banded(120, 3, seed=0)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type=ksp_type, rtol=1e-10,
                maxit=500)
    assert int(res.reason) > 0, reason_str(res.reason)
    err = np.linalg.norm(np.asarray(res.x) - u)
    assert err < 1e-6, err


def test_gmres_matches_scipy_iterates():
    """Unpreconditioned GMRES residual history should match SciPy's GMRES
    (same algorithm, same arithmetic) to tight tolerance."""
    a = problems.nonsym_banded(150, 2, 2, seed=3)
    u, b = manufactured(a, seed=1)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", rtol=1e-10,
                restart=30, maxit=300)
    x_sp, info = spla.gmres(a, b, rtol=1e-10, restart=30, maxiter=300)
    assert info == 0 and int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), x_sp, rtol=1e-6, atol=1e-8)


def test_gmres_restart_cycles():
    a = problems.nonsym_banded(200, 3, 3, seed=5, dominance=0.3)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", rtol=1e-8,
                restart=10, maxit=2000)
    assert int(res.its) > 10  # forced through multiple restart cycles
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pc_type", ["jacobi", "lu", "spike", "bjacobi"])
def test_preconditioned_gmres(pc_type):
    a = problems.spd_banded(256, 4, seed=2)
    u, b = manufactured(a)
    opts = Options({"pc_spike_partitions": "8", "pc_bjacobi_blocks": "8"})
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres",
                pc_type=pc_type, options=opts, rtol=1e-10, maxit=300)
    assert int(res.reason) > 0, (pc_type, reason_str(res.reason))
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-7)
    if pc_type in ("lu", "spike"):
        # exact factorization preconditioner: 1-2 iterations
        assert int(res.its) <= 2, int(res.its)


def test_preonly_direct_solve():
    a = problems.tridiag_laplacian(500)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="preonly",
                pc_type="lu")
    assert int(res.reason) == CONVERGED_ITS
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-8)


def test_banded_pc_from_general_sparse():
    """PCBANDED flow: general sparse operator, band extracted as the
    preconditioner (/root/reference/src/matbanded.c:165-192)."""
    a = problems.general_sparse(300, seed=7)
    u, b = manufactured(a)
    opts = Options({"pc_banded_kmax": "60", "pc_banded_frac": "0.999",
                    "banded_pc_spike_partitions": "4"})
    pc = make_pc("banded", a, opts)
    assert pc.inner is not None and pc.inner.name == "spike"
    assert pc.info["k"] <= 60
    res = solve(a, jnp.asarray(b), pc=pc, ksp_type="gmres", rtol=1e-10,
                maxit=400)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)


def test_bicgstab_illconditioned_with_spike_pc():
    """BASELINE config 3 skeleton: nonsymmetric system, SPIKE-preconditioned
    BiCGStab."""
    a = problems.nonsym_banded(400, 5, 5, seed=11, dominance=0.05)
    u, b = manufactured(a, seed=4)
    opts = Options({"pc_spike_partitions": "8"})
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="bcgs",
                pc_type="spike", options=opts, rtol=1e-12, maxit=100)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7, atol=1e-8)


def test_diverged_its():
    a = problems.nonsym_banded(100, 2, 2, seed=13, dominance=0.01)
    _, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", rtol=1e-14,
                maxit=3)
    assert int(res.reason) == DIVERGED_ITS


def test_history_monotone_and_trimmed():
    a = problems.spd_banded(128, 3, seed=1)
    _, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="cg", rtol=1e-10,
                maxit=200)
    h = np.asarray(res.history)
    assert np.isfinite(h[: int(res.its) + 1]).all()
    assert np.isnan(h[int(res.its) + 1:]).all()
    assert h[int(res.its)] < h[0]


def test_options_drive_solver_selection():
    a = problems.spd_banded(90, 2, seed=6)
    u, b = manufactured(a)
    opts = Options.from_argv(
        "-ksp_type cg -ksp_rtol 1e-11 -pc_type jacobi -ksp_max_it 500".split())
    res = solve(banded_of(a), jnp.asarray(b), options=opts)
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7)
    assert opts.options_left() == []


def test_make_solver_reuse_jitted():
    a = problems.spd_banded(200, 3, seed=9)
    solver = make_solver(banded_of(a), ksp_type="gmres", pc_type="lu",
                         rtol=1e-10)
    for seed in (1, 2):
        u, b = manufactured(a, seed=seed)
        res = solver(jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-8)


def test_right_preconditioning():
    a = problems.nonsym_banded(150, 3, 3, seed=15)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres",
                pc_type="spike", side="right", rtol=1e-10,
                options=Options({"pc_spike_partitions": "4"}))
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-8)


def test_preonly_real_history_and_nan_reason():
    """preonly: history must be real-dtyped even for complex systems, and a
    garbage PC application must surface DIVERGED_NANORINF (round-1 VERDICT)."""
    import jax.numpy as jnp
    import numpy as np
    from spike_petsc_tpu.solvers.krylov import preonly
    from spike_petsc_tpu.solvers.types import CONVERGED_ITS, DIVERGED_NANORINF

    n = 16
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.uniform(1.0, 2.0, n) + 1j * rng.uniform(0.5, 1.0, n))
    b = jnp.asarray(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    res = preonly(lambda v: d * v, b, None, lambda v: v / d)
    assert not jnp.iscomplexobj(res.history)
    assert int(res.reason) == CONVERGED_ITS

    bad = preonly(lambda v: d * v, b, None, lambda v: v * jnp.nan)
    assert int(bad.reason) == DIVERGED_NANORINF


def test_gmres_true_residual_monitor():
    """monitor_true records unpreconditioned norms alongside the
    preconditioned history (-ksp_monitor_true_residual parity)."""
    import jax.numpy as jnp
    import numpy as np
    from spike_petsc_tpu.models import problems
    from spike_petsc_tpu import sparse as hsp
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.solvers.krylov import gmres

    a = problems.illscaled_nonsym(300, 3, 3, seed=2, scale_decades=4.0,
                                  permute=False)
    data, kl, ku = hsp.csr_to_banded_arrays(hsp.as_csr(a))
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    u = np.ones(300)
    b = jnp.asarray(a @ u)
    d = jnp.asarray(a.diagonal())
    mv = lambda v: banded_matvec(bm, v)
    res = gmres(mv, b, None, lambda v: v / d, rtol=1e-10, maxit=200,
                monitor_true=True)
    assert res.true_history is not None
    assert int(res.reason) > 0
    th = np.asarray(res.true_history)
    its = int(res.its)
    # entries recorded for every iteration, finite, and the last one matches
    # the directly computed true residual norm
    assert np.all(np.isfinite(th[:its + 1]))
    x = np.asarray(res.x)
    true_rn = np.linalg.norm(np.asarray(b) - a @ x)
    np.testing.assert_allclose(th[its], true_rn, rtol=1e-3, atol=1e-10)
    # preconditioned and true histories must differ (ill-scaled diagonal PC)
    ph = np.asarray(res.history)
    assert not np.allclose(ph[:its + 1], th[:its + 1])


def test_as_matvec_blocktri_pallas_route():
    """impl='blocktri' converts the band once to block-tridiagonal form and
    applies batched block products; parity with banded_matvec."""
    import jax
    from spike_petsc_tpu.solvers import operator as op_mod
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec

    n, k = 700, 20
    w = 2 * k + 1
    key = jax.random.PRNGKey(3)
    data = jax.random.uniform(key, (n, w), jnp.float32)
    bm = BandedMatrix(data=data, kl=k, ku=k)
    x = jax.random.uniform(jax.random.fold_in(key, 1), (n,), jnp.float32)
    ref = banded_matvec(bm, x)
    mv, nn, _ = op_mod.as_matvec(bm, impl="blocktri")
    assert nn == n and mv._route == "blocktri"
    np.testing.assert_allclose(np.asarray(mv(x)), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_as_matvec_impl_routing():
    """-mat_matvec_impl selects the banded operator route: blocktri (forced
    conversion), xla, auto — all parity with banded_matvec; an explicit
    route the operator cannot take raises instead of degrading."""
    import jax
    import pytest
    from spike_petsc_tpu.solvers import operator as op_mod
    from spike_petsc_tpu.ops.band import BandedMatrix, banded_matvec
    from spike_petsc_tpu.solvers.ksp import solve
    from spike_petsc_tpu.utils.options import Options

    n, k = 1024, 6
    w = 2 * k + 1
    key = jax.random.PRNGKey(5)
    data = jax.random.uniform(key, (n, w), jnp.float32, minval=-1, maxval=1)
    data = data.at[:, k].set(jnp.sum(jnp.abs(data), axis=1) + 1)
    bm = BandedMatrix(data=data, kl=k, ku=k)
    x = jax.random.uniform(jax.random.fold_in(key, 1), (n,), jnp.float32)
    ref = np.asarray(banded_matvec(bm, x))
    for impl in ("blocktri", "xla", "auto"):
        mv, nn, _ = op_mod.as_matvec(bm, impl=impl)
        assert nn == n
        np.testing.assert_allclose(np.asarray(mv(x)), ref,
                                   rtol=2e-5, atol=2e-5, err_msg=impl)
    # an f64 band cannot take the f32 blocktri conversion: explicit raises
    bm64 = BandedMatrix(data=data.astype(jnp.float64), kl=k, ku=k)
    with pytest.raises(ValueError, match="blocktri"):
        op_mod.as_matvec(bm64, impl="blocktri")
    # and the option threads through the options-driven solve surface
    u = jnp.ones((n,), jnp.float32)
    b = banded_matvec(bm, u)
    res = solve(bm, b, options=Options({"mat_matvec_impl": "blocktri",
                                        "ksp_rtol": 1e-8}),
                ksp_type="gmres", pc_type="jacobi")
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(u),
                               rtol=1e-4, atol=1e-4)


def test_pipecg_matches_cg_on_spd():
    """Pipelined CG is algebraically CG (Ghysels–Vanroose recurrences): same
    iterates, same residual history to rounding, same iteration count ±1 —
    the sharp check that the extra s/q/z recurrences track A·p, M⁻¹A·p
    correctly."""
    n = 400
    a = problems.spd_banded(n, 2, seed=3)
    bm = banded_of(a)
    u = np.random.default_rng(0).standard_normal(n)
    b = jnp.asarray(a @ u)
    r_pipe = solve(bm, b, ksp_type="pipecg", pc_type="jacobi", rtol=1e-10,
                   maxit=500)
    r_cg = solve(bm, b, ksp_type="cg", pc_type="jacobi", rtol=1e-10,
                 maxit=500)
    assert int(r_pipe.reason) > 0
    assert abs(int(r_pipe.its) - int(r_cg.its)) <= 1
    np.testing.assert_allclose(np.asarray(r_pipe.x), u, rtol=1e-6, atol=1e-7)
    # residual histories agree closely while both are defined
    k = min(int(r_pipe.its), int(r_cg.its))
    hp = np.asarray(r_pipe.history)[: k + 1]
    hc = np.asarray(r_cg.history)[: k + 1]
    np.testing.assert_allclose(hp, hc, rtol=1e-6, atol=1e-12)


def test_pipecg_single_fused_reduction_per_iteration():
    """The design contract: pipecg's loop body issues exactly ONE psum per
    iteration (cg issues two after its own fusion; pre-fusion three).
    Counted in the jaxpr of the solver traced with a mesh axis."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    from spike_petsc_tpu.solvers import krylov

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), ("p",))

    def count_psums(method):
        def local(bs):
            mv = lambda x: x  # identity operator: reductions still psum
            return method(mv, bs, axis_name="p", rtol=1e-12, maxit=5).x

        f = shard_map(local, mesh=mesh, in_specs=P("p"), out_specs=P("p"))
        txt = str(jax.make_jaxpr(f)(jnp.ones(64)))
        return txt.count("psum")

    n_pipe = count_psums(krylov.pipecg)
    n_cg = count_psums(krylov.cg)
    # jaxpr text counts include setup reductions (pipecg: bnorm + 1 fused
    # init; cg: bnorm + init rz + init norm) — the loop body contributes 1
    # (pipecg) vs 2 (cg) occurrences
    assert n_pipe < n_cg, (n_pipe, n_cg)


def test_minres_symmetric_indefinite():
    """MINRES's raison d'être: a symmetric but INDEFINITE operator (shifted
    Laplacian with the shift strictly inside the spectrum) where CG's
    short recurrence breaks down but MINRES minimizes the residual."""
    n = 200
    lap = problems.tridiag_laplacian(n)
    evals = np.linalg.eigvalsh(lap.toarray())
    sigma = 0.5 * (evals[n // 3] + evals[n // 3 + 1])  # between eigenvalues
    import scipy.sparse as sp
    a = (lap - sigma * sp.eye(n, format="csr")).tocsr()
    assert np.linalg.eigvalsh(a.toarray()).min() < 0 < \
        np.linalg.eigvalsh(a.toarray()).max()
    u, b = manufactured(a, seed=1)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), ksp_type="minres", rtol=1e-10,
                maxit=2000)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)


def test_minres_spd_preconditioned_matches_direct():
    """SPD system + SPD (jacobi) preconditioner: converges to the direct
    solution; residual history is monotone (MINRES minimizes ||r||)."""
    a = problems.spd_banded(300, 4, seed=5)
    u, b = manufactured(a, seed=2)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), ksp_type="minres", pc_type="jacobi",
                rtol=1e-11, maxit=1000)
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-8)
    h = np.asarray(res.history)[: int(res.its) + 1]
    assert np.all(np.diff(h) <= 1e-12 + 1e-7 * h[:-1])


def test_minres_indefinite_pc_reports_breakdown():
    """An indefinite preconditioner violates MINRES's SPD-M contract: the
    β² = <r, M⁻¹r> inner product goes negative and the solver must stop
    with DIVERGED_BREAKDOWN, not emit NaNs."""
    import scipy.sparse as sp
    from spike_petsc_tpu.solvers.types import DIVERGED_BREAKDOWN
    a = problems.spd_banded(50, 2, seed=0)
    u, b = manufactured(a)
    bm = banded_of(a)
    sgn = jnp.asarray(np.where(np.arange(50) % 2 == 0, 1.0, -1.0))
    pc_bad = lambda x: sgn * x  # symmetric, indefinite
    from spike_petsc_tpu.solvers import krylov
    from spike_petsc_tpu.solvers.operator import as_matvec
    mv, _, _ = as_matvec(bm)
    res = krylov.minres(mv, jnp.asarray(b), pc_apply=pc_bad, rtol=1e-10,
                        maxit=100)
    assert int(res.reason) == DIVERGED_BREAKDOWN
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_arnoldi_ritz_estimates_extreme_eigs():
    """The Ritz values of a short Arnoldi run bracket into the true spectrum
    and the largest Ritz value approaches λmax — the property chebyshev
    esteig relies on."""
    from spike_petsc_tpu.solvers import estimate_extreme_eigs
    from spike_petsc_tpu.solvers.operator import as_matvec
    a = problems.spd_banded(250, 3, seed=7)
    evals = np.linalg.eigvalsh(a.toarray())
    mv, n, dt = as_matvec(banded_of(a))
    ritz = estimate_extreme_eigs(mv, n, dt, m=30, seed=1)
    assert ritz.size > 0
    assert abs(ritz.real.max() - evals.max()) < 0.02 * abs(evals.max())
    # Ritz values live inside the field of values: within the spectrum range
    assert ritz.real.max() <= evals.max() * (1 + 1e-8)
    assert ritz.real.min() >= evals.min() * (1 - 1e-8) - 1e-12


def test_chebyshev_esteig_converges_where_default_bounds_fail():
    """Unpreconditioned 2-D Laplacian has λmax ≈ 8: the fixed default
    bounds [0.1, 1.1] (tuned for preconditioned spectra) diverge, while
    -ksp_chebyshev_esteig picks working bounds from Ritz values — the
    whole point of KSPChebyshevEstEig."""
    a = problems.laplacian_2d(16, 16)
    u, b = manufactured(a)
    bm = banded_of(a)
    bad = solve(bm, jnp.asarray(b), ksp_type="chebyshev", rtol=1e-8,
                maxit=300)
    assert int(bad.reason) < 0  # diverges (bounds exclude most of spectrum)
    opts = Options.from_argv(["-ksp_type", "chebyshev",
                              "-ksp_chebyshev_esteig",
                              "-ksp_chebyshev_esteig_steps", "20",
                              "-ksp_rtol", "1e-8", "-ksp_max_it", "2000"])
    good = solve(bm, jnp.asarray(b), options=opts)
    assert int(good.reason) > 0, reason_str(good.reason)
    np.testing.assert_allclose(np.asarray(good.x), u, rtol=1e-5, atol=1e-6)


def test_chebyshev_eigenvalues_option_pins_bounds():
    """-ksp_chebyshev_eigenvalues emin,emax: explicit spectral bounds via
    the options database (and they win over esteig when both are given)."""
    a = problems.laplacian_2d(12, 12)
    u, b = manufactured(a)
    evals = np.linalg.eigvalsh(a.toarray())
    bm = banded_of(a)
    opts = Options.from_argv([
        "-ksp_type", "chebyshev", "-ksp_chebyshev_eigenvalues",
        f"{0.9 * evals.min()},{1.1 * evals.max()}",
        "-ksp_chebyshev_esteig",  # ignored: explicit bounds win
        "-ksp_rtol", "1e-8", "-ksp_max_it", "3000"])
    res = solve(bm, jnp.asarray(b), options=opts)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)


def test_compute_eigenvalues_prints(capsys):
    """-ksp_compute_eigenvalues prints Ritz estimates after the solve
    (PETSc diagnostic parity); extreme printed values match the true
    spectrum of the preconditioned operator reasonably."""
    a = problems.spd_banded(150, 3, seed=3)
    u, b = manufactured(a)
    bm = banded_of(a)
    opts = Options.from_argv(["-ksp_type", "gmres", "-ksp_rtol", "1e-10",
                              "-ksp_compute_eigenvalues"])
    res = solve(bm, jnp.asarray(b), options=opts)
    assert int(res.reason) > 0
    out = capsys.readouterr().out
    assert "Iteratively computed eigenvalues" in out
    vals = [float(l.split(" + ")[0]) for l in out.splitlines()
            if " + " in l and l.strip().endswith("i")]
    assert len(vals) >= 2
    evals = np.linalg.eigvalsh(a.toarray())
    assert vals[-1] <= evals.max() * (1 + 1e-6)
    assert vals[0] >= evals.min() * (1 - 1e-6) - 1e-12


def test_richardson_scale_option():
    """-ksp_richardson_scale wires KSPRichardsonSetScale through options."""
    a = problems.spd_banded(100, 2, seed=4)
    u, b = manufactured(a)
    bm = banded_of(a)
    opts = Options.from_argv(["-ksp_type", "richardson",
                              "-ksp_richardson_scale", "0.5",
                              "-ksp_rtol", "1e-9", "-ksp_max_it", "500"])
    res = solve(bm, jnp.asarray(b), pc_type="lu", options=opts)
    assert int(res.reason) > 0
    # scale 0.5 with an exact-LU PC: error halves per iteration -> needs
    # strictly more iterations than scale 1 (which converges immediately)
    res1 = solve(bm, jnp.asarray(b), ksp_type="richardson", pc_type="lu",
                 rtol=1e-9, maxit=500)
    assert int(res.its) > int(res1.its)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-7)


def test_bicg_matches_cg_on_spd():
    """On SPD systems with a symmetric PC, BiCG generates the SAME iterates
    as CG (the classical equivalence) — a sharp correctness check of the
    shadow recurrence and the transpose operator plumbing."""
    from spike_petsc_tpu import solve
    n = 400
    a = problems.spd_banded(n, 2, seed=3)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    u = np.random.default_rng(0).standard_normal(n)
    b = jnp.asarray(a @ u)
    r_bicg = solve(bm, b, ksp_type="bicg", pc_type="jacobi", rtol=1e-10,
                   maxit=500)
    r_cg = solve(bm, b, ksp_type="cg", pc_type="jacobi", rtol=1e-10,
                 maxit=500)
    assert int(r_bicg.reason) > 0
    assert abs(int(r_bicg.its) - int(r_cg.its)) <= 2
    np.testing.assert_allclose(np.asarray(r_bicg.x), u, rtol=1e-6, atol=1e-7)


def test_bicg_nonsymmetric_with_transpose_pcs():
    """BiCG on a nonsymmetric system: the PC transpose applies come from
    spike_transpose on the SAME stored factors (PCApplyTranspose role);
    direct-grade PCs converge in ~1 iteration.  Complex scalars exercise
    the Hermitian conjugation wrapping."""
    from spike_petsc_tpu import solve, Options
    n = 400
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(n)
    b = jnp.asarray(a @ u)
    for pc_type, extra in (("lu", []),
                           ("spike", ["-pc_spike_partitions", "8"]),
                           # store_lt: the regular-form transpose builds
                           # from the L blocks kept at factor time
                           ("spike", ["-pc_spike_partitions", "8",
                                      "-pc_spike_store_lt", "1"])):
        res = solve(bm, b, ksp_type="bicg", pc_type=pc_type,
                    options=Options.from_argv(extra), rtol=1e-12, maxit=50)
        assert int(res.reason) > 0 and int(res.its) <= 3, (pc_type, res)
        np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-8,
                                   atol=1e-9)
    ac = (a + 1j * 0.3 * problems.nonsym_banded(n, 3, 2, seed=11)).tocsr()
    dc, klc, kuc = hsp.csr_to_banded_arrays(ac)
    bmc = BandedMatrix(data=jnp.asarray(dc), kl=klc, ku=kuc)
    uc = u + 1j * rng.standard_normal(n)
    res = solve(bmc, jnp.asarray(ac @ uc), ksp_type="bicg", pc_type="lu",
                rtol=1e-12, maxit=60)
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), uc, rtol=1e-7, atol=1e-8)


def test_bicg_requires_transpose_operator():
    """A bare matvec callable cannot be transposed: bicg through the KSP
    layer fails with a clear error instead of silently mis-iterating."""
    from spike_petsc_tpu import solve
    import pytest as _pytest
    b = jnp.ones(16)
    with _pytest.raises(TypeError, match="transpose"):
        solve(lambda x: 2.0 * x, b, ksp_type="bicg")


def test_solve_transpose_kspsolvetranspose():
    """solve(..., transpose=True) (KSPSolveTranspose role): the operator
    transposes host-side and the PC applies M^{-T} from its stored factors
    via PC.transpose()."""
    from spike_petsc_tpu import solve
    n = 333
    a = problems.nonsym_banded(n, 3, 2, seed=7)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    g = np.random.default_rng(3).standard_normal(n)
    lam_e = np.linalg.solve(a.toarray().T, g)
    for kt, pct in (("gmres", "spike"), ("bcgs", "lu")):
        res = solve(bm, jnp.asarray(g), ksp_type=kt, pc_type=pct,
                    options=Options({"pc_spike_partitions": 8}),
                    rtol=1e-12, maxit=40, transpose=True)
        assert int(res.reason) > 0 and int(res.its) <= 3
        np.testing.assert_allclose(np.asarray(res.x), lam_e, rtol=1e-9,
                                   atol=1e-10)


def test_gmres_norm_type_unpreconditioned():
    """-ksp_norm_type unpreconditioned (KSPSetNormType): with a badly
    scaled left PC, the default preconditioned test stops far from the
    true tolerance; the unpreconditioned test converges on the TRUE
    residual (and reports it as rnorm)."""
    from spike_petsc_tpu.ops.band import banded_matvec
    from spike_petsc_tpu.solvers.krylov import gmres
    n = 300
    a = problems.spd_banded(n, 2, seed=3)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    b = jnp.asarray(a @ np.ones(n))
    mv = lambda v: banded_matvec(bm, v)
    d = jnp.asarray(np.logspace(0, -3, n))       # badly scaled "PC"
    pc = lambda r: d * r
    rp = gmres(mv, b, None, pc, rtol=1e-4, maxit=400, restart=100)
    ru = gmres(mv, b, None, pc, rtol=1e-4, maxit=400, restart=100,
               norm_type="unpreconditioned")
    tb = float(jnp.linalg.norm(b))
    tp = float(jnp.linalg.norm(b - mv(rp.x))) / tb
    tu = float(jnp.linalg.norm(b - mv(ru.x))) / tb
    assert int(ru.reason) > 0 and tu <= 1e-4
    assert tp > 10 * tu                          # default stopped early
    np.testing.assert_allclose(float(ru.rnorm), tu * tb, rtol=1e-12)
    # true_history is populated and ends at the converged norm
    th = np.asarray(ru.true_history)
    np.testing.assert_allclose(th[int(ru.its)], float(ru.rnorm), rtol=1e-12)
    with pytest.raises(ValueError, match="norm_type"):
        gmres(mv, b, None, pc, norm_type="bogus")


def test_gmres_cgs_refinement_types():
    """-ksp_gmres_cgs_refinement_type (KSPGMRESSetCGSRefinementType):
    never / ifneeded / always all converge to the same solution; 'never'
    halves per-iteration basis traffic, 'ifneeded' fuses the DGKS test
    into the gram psum.  Checked through the raw method, the option
    surface, and for complex scalars (conjugated gram rows)."""
    from spike_petsc_tpu.ops.band import banded_matvec
    from spike_petsc_tpu.solvers.krylov import gmres
    n = 400
    a = problems.nonsym_banded(n, 3, 3, seed=5)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    xe = np.random.default_rng(0).standard_normal(n)
    b = jnp.asarray(a @ xe)
    mv = lambda v: banded_matvec(bm, v)
    sols = {}
    for mode in ("always", "never", "ifneeded"):
        r = gmres(mv, b, None, None, rtol=1e-12, maxit=300, restart=60,
                  cgs_refinement=mode)
        assert int(r.reason) > 0, mode
        np.testing.assert_allclose(np.asarray(r.x), xe, rtol=1e-8,
                                   atol=1e-9, err_msg=mode)
        sols[mode] = np.asarray(r.x)
    with pytest.raises(ValueError, match="cgs_refinement"):
        gmres(mv, b, None, None, maxit=2, cgs_refinement="bogus")
    # option plumbing end-to-end (fgmres exercises the flexible loop)
    res = solve(bm, b, options=Options.from_argv([
        "-ksp_type", "fgmres", "-pc_type", "jacobi",
        "-ksp_gmres_cgs_refinement_type", "ifneeded",
        "-ksp_rtol", "1e-12", "-ksp_max_it", "300"]))
    assert int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), xe, rtol=1e-8, atol=1e-9)
    # complex scalars through the ifneeded path (fused psum keeps dtypes)
    ac = a.astype(np.complex128) + 1j * 0.1 * hsp.sp.eye(n, format="csr")
    from spike_petsc_tpu.ops.band import banded_from_dense
    bmc = banded_from_dense(jnp.asarray(ac.toarray()), kl=kl, ku=ku)
    bc = jnp.asarray(ac @ (xe + 0j))
    rc = gmres(lambda v: banded_matvec(bmc, v), bc, None, None,
               rtol=1e-12, maxit=300, restart=60,
               cgs_refinement="ifneeded")
    assert int(rc.reason) > 0
    np.testing.assert_allclose(np.asarray(rc.x), xe + 0j, rtol=1e-8,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# Normal-equations family (KSPCGNE/KSPLSQR) and transpose-free family
# (KSPCGS/KSPTFQMR)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ksp_type", ["cgne", "lsqr", "cgs", "tfqmr"])
def test_new_ksps_unpreconditioned_nonsymmetric(ksp_type):
    a = problems.nonsym_banded(120, 2, 2, seed=3)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type=ksp_type, rtol=1e-10,
                maxit=2000)
    assert int(res.reason) > 0, reason_str(res.reason)
    err = np.linalg.norm(np.asarray(res.x) - u)
    assert err < 1e-6, (ksp_type, err)


@pytest.mark.parametrize("ksp_type", ["cgne", "lsqr", "cgs", "tfqmr"])
def test_new_ksps_spike_pc_one_iteration(ksp_type):
    """With the exact SPIKE factorization as PC each method converges in
    one iteration — the PC (and for cgne/lsqr its TRANSPOSE apply on the
    stored factors) is wired correctly through make_solver."""
    a = problems.nonsym_banded(150, 3, 3, seed=7)
    u, b = manufactured(a, seed=2)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type=ksp_type,
                pc_type="spike", rtol=1e-10, maxit=50)
    assert int(res.reason) > 0, reason_str(res.reason)
    assert int(res.its) <= 2, int(res.its)
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-8


@pytest.mark.parametrize("fn_name", ["cgnr", "lsqr"])
def test_normal_equations_rectangular_least_squares(fn_name):
    """Rectangular (tall) least squares: both CGLS and LSQR reach the
    numpy.linalg.lstsq minimizer and report the normal-equations reason
    (the residual itself cannot reach rtol for an inconsistent system)."""
    from spike_petsc_tpu.solvers import krylov
    from spike_petsc_tpu.solvers.types import CONVERGED_RTOL_NORMAL

    rng = np.random.default_rng(0)
    M = rng.standard_normal((80, 30))
    b = rng.standard_normal(80)
    xs = np.linalg.lstsq(M, b, rcond=None)[0]
    Mj = jnp.asarray(M)
    fn = getattr(krylov, fn_name)
    res = fn(lambda x: Mj @ x, jnp.asarray(b),
             matvec_transpose=lambda y: Mj.T @ y, rtol=1e-12, maxit=500)
    assert int(res.reason) == CONVERGED_RTOL_NORMAL, reason_str(res.reason)
    assert np.linalg.norm(np.asarray(res.x) - xs) < 1e-8


def test_lsqr_nonzero_initial_guess_correction_form():
    """x0 enters LSQR through the residual correction (no M apply needed);
    the solution must be independent of the starting point."""
    a = problems.nonsym_banded(100, 2, 2, seed=9)
    u, b = manufactured(a, seed=4)
    x0 = jnp.asarray(np.random.default_rng(5).uniform(size=100))
    res = solve(banded_of(a), jnp.asarray(b), x0=x0, ksp_type="lsqr",
                pc_type="spike", rtol=1e-12, maxit=100)
    assert int(res.reason) > 0
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-8


def test_cgnr_complex_system():
    from spike_petsc_tpu.solvers import krylov

    rng = np.random.default_rng(11)
    n = 60
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    M += n * np.eye(n)
    xe = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = M @ xe
    Mj = jnp.asarray(M)
    res = krylov.cgnr(lambda x: Mj @ x, jnp.asarray(b),
                      matvec_transpose=lambda y: Mj.T @ y,
                      rtol=1e-12, maxit=500)
    assert int(res.reason) > 0, reason_str(res.reason)
    assert np.linalg.norm(np.asarray(res.x) - xe) < 1e-8


def test_cgs_matches_scipy_solution():
    a = problems.nonsym_banded(130, 2, 2, seed=13)
    u, b = manufactured(a, seed=6)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="cgs", rtol=1e-10,
                maxit=1000)
    x_sp, info = spla.cgs(a, b, rtol=1e-10, maxiter=1000)
    assert info == 0 and int(res.reason) > 0
    np.testing.assert_allclose(np.asarray(res.x), x_sp, rtol=1e-5, atol=1e-7)


def test_tfqmr_history_bounds_true_residual():
    """TFQMR's monitored history is Freund's tau*sqrt(m+1) residual BOUND:
    the recomputed true rnorm at exit must not exceed the last history
    entry (up to roundoff slack)."""
    a = problems.nonsym_banded(120, 2, 2, seed=3)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="tfqmr", rtol=1e-8,
                maxit=2000)
    assert int(res.reason) > 0
    last = float(np.asarray(res.history)[int(res.its)])
    assert float(res.rnorm) <= 10 * last + 1e-12


def test_cgne_requires_transpose_operator():
    from spike_petsc_tpu.solvers import krylov

    b = jnp.ones(10)
    with pytest.raises(ValueError, match="matvec_transpose"):
        krylov.cgnr(lambda x: x, b)
    with pytest.raises(ValueError, match="matvec_transpose"):
        krylov.lsqr(lambda x: x, b)


def test_extreme_singular_values_exact_at_full_steps():
    """m = n Golub-Kahan reproduces the exact extreme singular values."""
    from spike_petsc_tpu.solvers import krylov

    a = problems.nonsym_banded(80, 2, 2, seed=3)
    Ad = a.toarray()
    sv = np.linalg.svd(Ad, compute_uv=False)
    Mj = jnp.asarray(Ad)
    smax, smin = krylov.estimate_extreme_singular_values(
        lambda x: Mj @ x, lambda y: Mj.T @ y, 80, jnp.float64, m=80)
    np.testing.assert_allclose(smax, sv.max(), rtol=1e-8)
    np.testing.assert_allclose(smin, sv.min(), rtol=1e-6)


def test_compute_singularvalues_option_prints(capsys):
    """-ksp_compute_singularvalues prints the preconditioned-operator
    extreme singular values (PETSc KSPComputeExtremeSingularValues)."""
    from spike_petsc_tpu import Options

    a = problems.nonsym_banded(100, 2, 2, seed=5)
    u, b = manufactured(a)
    opts = Options.from_argv(["-ksp_compute_singularvalues"])
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres",
                pc_type="bjacobi", options=opts, rtol=1e-10, maxit=300)
    assert int(res.reason) > 0
    out = capsys.readouterr().out
    assert "extreme singular values" in out
    import re
    m = re.search(r"max (\S+) min (\S+) max/min (\S+)", out)
    smax, smin = float(m.group(1)), float(m.group(2))
    assert smax > smin > 0
    # bjacobi on a dominant band: preconditioned operator is well-
    # conditioned; the estimate must reflect that (cond < 10)
    assert smax / smin < 10


def test_gcr_nonsymmetric_and_restart():
    a = problems.nonsym_banded(200, 3, 3, seed=5, dominance=0.3)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gcr", rtol=1e-10,
                restart=25, maxit=600)
    assert int(res.reason) > 0, reason_str(res.reason)
    assert int(res.its) > 25          # exercises the restart boundary
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-6


def test_gcr_with_variable_pcksp():
    """GCR tolerates a between-iterations-varying PC (inner iterative
    solve), like fgmres — the PETSc-recommended pairing for PCKSP."""
    from spike_petsc_tpu import Options

    a = problems.nonsym_banded(200, 3, 3, seed=5, dominance=0.3)
    u, b = manufactured(a)
    opts = Options.from_argv(
        "-ksp_ksp_type gmres -ksp_pc_type bjacobi -ksp_ksp_rtol 1e-3".split())
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gcr", pc_type="ksp",
                options=opts, rtol=1e-10, maxit=100)
    assert int(res.reason) > 0, reason_str(res.reason)
    assert int(res.its) <= 10
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-7


def test_gcr_monitors_true_residual():
    """GCR's history IS the true residual (no Hessenberg estimate): each
    entry must equal ||b - A x_k|| of the returned final iterate at exit."""
    a = problems.nonsym_banded(150, 2, 2, seed=3)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gcr", rtol=1e-9,
                maxit=400)
    last = float(np.asarray(res.history)[int(res.its)])
    np.testing.assert_allclose(float(res.rnorm), last, rtol=1e-5, atol=1e-12)


def test_extreme_singular_values_exact_pc_breakdown():
    """M^{-1}A = I terminates the bidiagonalization at step 1; the broken-
    down step must NOT append a zero column (which would report smin=0 /
    cond=inf for a perfectly conditioned operator)."""
    from spike_petsc_tpu.solvers import krylov

    n = 50
    ident = lambda x: x
    smax, smin = krylov.estimate_extreme_singular_values(
        ident, ident, n, jnp.float64, m=20)
    np.testing.assert_allclose(smax, 1.0, rtol=1e-12)
    np.testing.assert_allclose(smin, 1.0, rtol=1e-12)


def test_bcgsl_beats_bcgs_on_skew_spectrum():
    """BiCGStab(ell): the degree-ell MR polynomial handles the strongly
    imaginary spectrum (0.6 I + skew) where plain bicgstab's real 1-step
    polynomial needs ~2x the matvecs (Sleijpen-Fokkema's motivating
    case)."""
    import scipy.sparse as sp

    n = 400
    A = sp.diags([0.6 * np.ones(n), np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1]).tocsr()
    u = np.ones(n)
    b = jnp.asarray(A @ u)
    r_l = solve(banded_of(A), b, ksp_type="bcgsl", rtol=1e-10, maxit=2000)
    r_1 = solve(banded_of(A), b, ksp_type="bcgs", rtol=1e-10, maxit=2000)
    assert int(r_l.reason) > 0 and int(r_1.reason) > 0
    assert int(r_l.its) < int(r_1.its)
    assert np.linalg.norm(np.asarray(r_l.x) - u) < 1e-6


def test_bcgsl_exact_pc_one_step():
    """Mid-cycle happy breakdown: an exact SPIKE PC converges the solve at
    the FIRST BiCG sub-step; the in-cycle gate must freeze there instead of
    amplifying rounding noise through the remaining ell-1 steps."""
    a = problems.nonsym_banded(200, 3, 3, seed=5)
    u, b = manufactured(a)
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="bcgsl",
                pc_type="spike", rtol=1e-10, maxit=50)
    assert int(res.reason) > 0, reason_str(res.reason)
    assert int(res.its) <= 2
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-8


def test_bcgsl_ell_option():
    from spike_petsc_tpu import Options

    a = problems.nonsym_banded(150, 2, 2, seed=3)
    u, b = manufactured(a)
    opts = Options.from_argv(["-ksp_bcgsl_ell", "4"])
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="bcgsl",
                options=opts, rtol=1e-9, maxit=800)
    assert int(res.reason) > 0
    # the history is written once per CYCLE at index its (ell sub-steps):
    # with ell=4 the first written entry sits at index 4 and indices 1..3
    # stay NaN — this detects the option not reaching the solver (the
    # default ell=2 would write index 2)
    h = np.asarray(res.history)
    assert np.isnan(h[1:4]).all() and np.isfinite(h[4]), h[:6]
    assert np.linalg.norm(np.asarray(res.x) - u) < 1e-5


def test_error_if_not_converged_flag():
    from spike_petsc_tpu import Options

    a = problems.nonsym_banded(150, 2, 2, seed=3, dominance=0.2)
    u, b = manufactured(a)
    opts = Options.from_argv(["-ksp_error_if_not_converged"])
    with pytest.raises(RuntimeError, match="did not converge"):
        solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", options=opts,
              rtol=1e-12, maxit=3)
    # converged solves pass through untouched
    res = solve(banded_of(a), jnp.asarray(b), ksp_type="gmres", options=opts,
                pc_type="spike", rtol=1e-10, maxit=50)
    assert int(res.reason) > 0


# ---------------------------------------------------------------------------
# KSPCR (conjugate residuals) and KSPLGMRES (augmented restarts)
# ---------------------------------------------------------------------------

def test_cr_spd_matches_direct():
    """CR on an SPD system: converges to the direct solution with a
    monotone TRUE-residual history (CR minimizes ||r||_{M^-1})."""
    a = problems.spd_banded(300, 4, seed=9)
    u, b = manufactured(a, seed=3)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), ksp_type="cr", rtol=1e-11, maxit=1000)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6, atol=1e-8)
    h = np.asarray(res.history)[: int(res.its) + 1]
    assert np.all(np.diff(h) <= 1e-12 + 1e-7 * h[:-1])


def test_cr_preconditioned_iteration_parity_with_cg():
    """With the exact SPIKE PC both CR and CG collapse immediately; with
    jacobi the CR iteration count is comparable to CG on the same system
    (same Krylov space, different optimality norms)."""
    a = problems.spd_banded(400, 5, seed=10)
    u, b = manufactured(a, seed=4)
    bm = banded_of(a)
    r_cr = solve(bm, jnp.asarray(b), ksp_type="cr", pc_type="jacobi",
                 rtol=1e-10, maxit=800)
    r_cg = solve(bm, jnp.asarray(b), ksp_type="cg", pc_type="jacobi",
                 rtol=1e-10, maxit=800)
    assert int(r_cr.reason) > 0 and int(r_cg.reason) > 0
    assert abs(int(r_cr.its) - int(r_cg.its)) <= 10
    np.testing.assert_allclose(np.asarray(r_cr.x), u, rtol=1e-6, atol=1e-7)
    res_exact = solve(bm, jnp.asarray(b), ksp_type="cr", pc_type="cholesky",
                      rtol=1e-10)
    assert int(res_exact.its) <= 2


def test_lgmres_matches_solution_and_beats_restarted_gmres():
    """LGMRES(30,2): correct solutions, and on a problem where GMRES(m)
    sawtooths the augmented cycles need no MORE total iterations."""
    a = problems.nonsym_banded(600, 3, 3, seed=12)
    u, b = manufactured(a, seed=5)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), ksp_type="lgmres", rtol=1e-10,
                maxit=600, restart=12)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)
    res_g = solve(bm, jnp.asarray(b), ksp_type="gmres", rtol=1e-10,
                  maxit=600, restart=12)
    assert int(res.its) <= int(res_g.its) + 2, (int(res.its), int(res_g.its))


def test_lgmres_aug0_is_gmres():
    """aug=0 reduces LGMRES exactly to restarted GMRES (same history)."""
    a = problems.nonsym_banded(200, 2, 2, seed=14)
    u, b = manufactured(a, seed=6)
    bm = banded_of(a)
    from spike_petsc_tpu.solvers.krylov import gmres, lgmres
    from spike_petsc_tpu.solvers.operator import as_matvec
    mv, _, _ = as_matvec(bm)
    r1 = lgmres(mv, jnp.asarray(b), aug=0, restart=10, rtol=1e-10,
                maxit=200)
    r2 = gmres(mv, jnp.asarray(b), restart=10, rtol=1e-10, maxit=200)
    assert int(r1.its) == int(r2.its)
    h1 = np.asarray(r1.history)[: int(r1.its) + 1]
    h2 = np.asarray(r2.history)[: int(r2.its) + 1]
    np.testing.assert_allclose(h1, h2, rtol=1e-10)


def test_lgmres_augment_option_and_pc():
    """-ksp_lgmres_augment wiring + preconditioned LGMRES through solve()."""
    a = problems.nonsym_banded(300, 4, 2, seed=15)
    u, b = manufactured(a, seed=7)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), options=Options(
        {"ksp_type": "lgmres", "ksp_lgmres_augment": "3",
         "ksp_gmres_restart": "8", "pc_type": "jacobi",
         "ksp_rtol": "1e-10", "ksp_max_it": "400"}))
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-5, atol=1e-6)


def test_symmlq_spd_and_indefinite():
    """SYMMLQ (Paige-Saunders LQ): SPD and symmetric-INDEFINITE systems
    both converge to the direct solution (iterates stay in range(A))."""
    a = problems.spd_banded(200, 3, seed=16)
    u, b = manufactured(a, seed=8)
    bm = banded_of(a)
    res = solve(bm, jnp.asarray(b), ksp_type="symmlq", rtol=1e-12,
                maxit=500)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-8, atol=1e-9)

    import scipy.sparse as sp
    n = 150
    lap = problems.tridiag_laplacian(n)
    evals = np.linalg.eigvalsh(lap.toarray())
    sigma = 0.5 * (evals[n // 3] + evals[n // 3 + 1])
    ai = (lap - sigma * sp.eye(n, format="csr")).tocsr()
    ui, bi = manufactured(ai, seed=9)
    res_i = solve(banded_of(ai), jnp.asarray(bi), ksp_type="symmlq",
                  rtol=1e-10, maxit=2000)
    assert int(res_i.reason) > 0, reason_str(res_i.reason)
    np.testing.assert_allclose(np.asarray(res_i.x), ui, rtol=1e-6,
                               atol=1e-7)


def test_symmlq_preconditioned_and_x0():
    """SPD preconditioner + nonzero initial guess through the public
    surface; indefinite PC reports breakdown."""
    a = problems.spd_banded(300, 4, seed=17)
    u, b = manufactured(a, seed=10)
    bm = banded_of(a)
    x0 = jnp.asarray(np.random.default_rng(11).standard_normal(300))
    res = solve(bm, jnp.asarray(b), x0=x0, ksp_type="symmlq",
                pc_type="jacobi", rtol=1e-11, maxit=1000)
    assert int(res.reason) > 0, reason_str(res.reason)
    np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-7, atol=1e-8)

    from spike_petsc_tpu.solvers.krylov import symmlq
    from spike_petsc_tpu.solvers.operator import as_matvec
    from spike_petsc_tpu.solvers.types import DIVERGED_BREAKDOWN
    mv, _, _ = as_matvec(bm)
    bad_pc = lambda v: -v          # negative definite preconditioner
    r = symmlq(mv, jnp.asarray(b), None, bad_pc, rtol=1e-10, maxit=100)
    assert int(r.reason) == DIVERGED_BREAKDOWN


def test_pc_jacobi_types():
    """-pc_jacobi_type diagonal|rowmax|rowsum and -pc_jacobi_abs
    (PCJacobiSetType / PCJacobiSetUseAbs): the scaling vector matches the
    dense definition on both BandedMatrix and CSR pmats; the PC matrix is
    diagonal, hence self-transpose."""
    import scipy.sparse as sp

    a = problems.nonsym_banded(60, 2, 2, seed=7)
    data, kl, ku = hsp.csr_to_banded_arrays(a)
    bm = BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(60))
    Ad = a.toarray()
    for jt, dfn in (("diagonal", lambda A: np.diag(A)),
                    ("rowmax", lambda A: np.abs(A).max(axis=1)),
                    ("rowsum", lambda A: np.abs(A).sum(axis=1))):
        for pmat in (bm, a):
            pc = make_pc("jacobi", pmat, Options({"pc_jacobi_type": jt}))
            np.testing.assert_allclose(np.asarray(pc.apply(x)),
                                       np.asarray(x) / dfn(Ad),
                                       rtol=1e-12, err_msg=jt)
            np.testing.assert_allclose(np.asarray(pc.transpose().apply(x)),
                                       np.asarray(pc.apply(x)), rtol=1e-14)
    A2 = Ad.copy()
    np.fill_diagonal(A2, -np.abs(np.diag(A2)))
    d2, _, _ = hsp.csr_to_banded_arrays(sp.csr_matrix(A2))
    bm2 = BandedMatrix(data=jnp.asarray(d2), kl=kl, ku=ku)
    pc = make_pc("jacobi", bm2, Options({"pc_jacobi_abs": True}))
    np.testing.assert_allclose(np.asarray(pc.apply(x)),
                               np.asarray(x) / np.abs(np.diag(A2)),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="pc_jacobi_type"):
        make_pc("jacobi", bm, Options({"pc_jacobi_type": "bogus"}))
    # Options({...: True}) programmatic-bool construction parses (get_bool)
    assert Options({"f": True}).get_bool("f") is True
    assert Options({"f": False}).get_bool("f") is False
