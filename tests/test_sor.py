"""Block-SSOR preconditioner (PCSOR role, dense-block granularity)."""

import numpy as np
import pytest
import jax.numpy as jnp

from spike_petsc_tpu import BandedMatrix, Options, solve
from spike_petsc_tpu import sparse as hsp
from spike_petsc_tpu.models import problems
from spike_petsc_tpu.solvers.pc import make_pc
from spike_petsc_tpu.solvers.types import reason_str


def banded_of(acsr):
    data, kl, ku = hsp.csr_to_banded_arrays(acsr)
    return BandedMatrix(data=jnp.asarray(data), kl=kl, ku=ku)


def test_ssor_accelerates_cg():
    a = problems.spd_banded(400, 4, seed=41)
    u = np.ones(400)
    b = jnp.asarray(a @ u)
    bm = banded_of(a)
    r_plain = solve(bm, b, ksp_type="cg", rtol=1e-10, maxit=800)
    r_ssor = solve(bm, b, ksp_type="cg", pc_type="sor", rtol=1e-10,
                   maxit=800)
    assert int(r_ssor.reason) > 0, reason_str(r_ssor.reason)
    assert int(r_ssor.its) < int(r_plain.its)
    np.testing.assert_allclose(np.asarray(r_ssor.x), u, rtol=1e-7,
                               atol=1e-8)


def test_sor_forward_backward_nonsym():
    a = problems.nonsym_banded(300, 3, 3, seed=43)
    u = np.ones(300)
    b = jnp.asarray(a @ u)
    bm = banded_of(a)
    for stype in ("forward", "backward"):
        res = solve(bm, b, options=Options(
            {"ksp_type": "gmres", "pc_type": "sor", "pc_sor_type": stype,
             "ksp_rtol": "1e-10", "ksp_max_it": "400"}))
        assert int(res.reason) > 0, (stype, reason_str(res.reason))
        np.testing.assert_allclose(np.asarray(res.x), u, rtol=1e-6,
                                   atol=1e-7)


def test_sor_omega_its_options():
    a = problems.spd_banded(300, 3, seed=44)
    bm = banded_of(a)
    u = np.ones(300)
    b = jnp.asarray(a @ u)
    r1 = solve(bm, b, options=Options(
        {"ksp_type": "cg", "pc_type": "sor", "pc_sor_omega": "1.3",
         "ksp_rtol": "1e-10"}))
    r2 = solve(bm, b, options=Options(
        {"ksp_type": "cg", "pc_type": "sor", "pc_sor_its": "3",
         "ksp_rtol": "1e-10"}))
    assert int(r1.reason) > 0 and int(r2.reason) > 0
    # more inner sweeps -> stronger PC -> no more outer iterations
    r0 = solve(bm, b, ksp_type="cg", pc_type="sor", rtol=1e-10)
    assert int(r2.its) <= int(r0.its)
    with pytest.raises(ValueError, match="pc_sor_omega"):
        make_pc("sor", bm, Options({"pc_sor_omega": "2.5"}))


def test_sor_transpose_adjoint_identity():
    a = problems.nonsym_banded(200, 2, 3, seed=45)
    bm = banded_of(a)
    pc = make_pc("sor", bm, Options())
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(200))
    y = jnp.asarray(rng.standard_normal(200))
    lhs = float(jnp.vdot(pc.apply(x), y))
    rhs = float(jnp.vdot(x, pc.transpose().apply(y)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_sor_apply_many_matches_vmapped_apply():
    a = problems.spd_banded(256, 3, seed=46)
    bm = banded_of(a)
    pc = make_pc("sor", bm, Options({"pc_sor_block": "8"}))
    R = jnp.asarray(np.random.default_rng(6).standard_normal((256, 4)))
    Z1 = np.asarray(pc.apply_many(R))
    Z2 = np.stack([np.asarray(pc.apply(R[:, j])) for j in range(4)], axis=1)
    np.testing.assert_allclose(Z1, Z2, rtol=1e-12, atol=1e-12)


def test_ssor_symmetric_pc_is_symmetric():
    """On a symmetric matrix the symmetric sweep's M is symmetric: valid
    for cg — check <M^-1 x, y> == <x, M^-1 y>."""
    a = problems.spd_banded(128, 2, seed=47)
    bm = banded_of(a)
    pc = make_pc("sor", bm, Options())
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(128))
    y = jnp.asarray(rng.standard_normal(128))
    np.testing.assert_allclose(float(jnp.vdot(pc.apply(x), y)),
                               float(jnp.vdot(x, pc.apply(y))), rtol=1e-10)
