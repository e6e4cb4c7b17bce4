"""Machine-checked communication schedule of the distributed tier.

Correctness of the multi-device tier is covered by
tests/test_parallel.py, but nothing pinned *what collectives* the compiled
SPMD program issues — a refactor regressing from one all_gather + O(1)
psums per step to something unrolled (program size O(nblk)) or quadratic
would pass every numeric test. These tests lower the real drivers to
StableHLO on the 8-device CPU mesh and assert the exact collective-op
composition of the program text, and that it is INDEPENDENT of the matrix
size (all collectives live inside `while` loop bodies, traced once).

This is the only multi-chip perf evidence a single-chip environment can
produce (SURVEY.md §2.5 mapping). The reference's analog is its
stream-ordering discipline comments + task-join semantics
(reference blas/sgemm.c:254-263, multigpu/multigpu.c:355-375).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cholesky_tpu.parallel.blockcyclic import BlockCyclic, distribute
from cholesky_tpu.parallel.potrf import logdet_dist, potrf_dist
from cholesky_tpu.parallel.trsm import trsm_factor_dist
from cholesky_tpu.parallel.trtri import lauum_dist, potri_dist, trtri_dist

NB = 256

COLLECTIVES = ("all_gather", "all_reduce", "collective_permute",
               "all_to_all", "reduce_scatter", "all_to_all_v")


def _counts(text):
    return {k: len(re.findall(rf"\bstablehlo\.{k}\b", text))
            for k in COLLECTIVES}


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()), ("d",))


def _bc(mesh, nblk):
    A = jnp.eye(NB * nblk, dtype=jnp.float64) * 4.0
    return distribute(A, mesh, nb=NB)


def _jaxify(x):
    return x.local if isinstance(x, BlockCyclic) else x


def _lower(bc, fn):
    """Lower fn(BlockCyclic) to StableHLO text, local array as the arg."""
    def wrapped(loc):
        b2 = BlockCyclic(local=loc, n=bc.n, nb=bc.nb, mesh=bc.mesh,
                         axis=bc.axis)
        return jax.tree.map(_jaxify, fn(b2),
                            is_leaf=lambda v: isinstance(v, BlockCyclic))
    return jax.jit(wrapped).lower(bc.local).as_text()


# --- potrf: per phase body exactly 1 all_gather (panel) + 1 psum
# (lookahead diagonal fold, or the serial psum_diag when lookahead=off),
# plus the prologue psums: block-0 factor + the info vma seed with
# lookahead on; with it off the prologue factor's psum is dead (its
# outputs are zeroed to keep the carry signature) and lowering DCEs it. --

@pytest.mark.parametrize("lookahead", [True, False])
def test_potrf_dist_schedule_composition(mesh, lookahead):
    phases = 4
    c = _counts(_lower(_bc(mesh, 8), lambda b: potrf_dist(
        b, tiles="ref", phases=phases, lookahead=lookahead)))
    assert c["all_gather"] == phases
    assert c["all_reduce"] == phases + (2 if lookahead else 1)
    assert c["collective_permute"] == c["all_to_all"] == 0
    assert c["reduce_scatter"] == c["all_to_all_v"] == 0


@pytest.mark.parametrize("lookahead", [True, False])
def test_potrf_dist_schedule_size_independent(mesh, lookahead):
    # Collectives must live inside loop bodies: doubling the matrix must
    # not change the program's collective-op census (guards against an
    # unrolled/quadratic schedule regression).
    f = lambda b: potrf_dist(b, tiles="ref", phases=4, lookahead=lookahead)
    small = _counts(_lower(_bc(mesh, 8), f))
    large = _counts(_lower(_bc(mesh, 16), f))
    assert small == large


def test_potrf_dist_single_phase_is_one_gather(mesh):
    c = _counts(_lower(_bc(mesh, 8), lambda b: potrf_dist(
        b, tiles="ref", phases=1, lookahead=True)))
    assert c["all_gather"] == 1 and c["all_reduce"] == 3


# --- trsm against the factor: 2 psums per step (diag broadcast + the
# substitution scatter-reduce), no gathers, both sweep directions. ----

@pytest.mark.parametrize("trans", ["N", "T"])
def test_trsm_factor_dist_schedule(mesh, trans):
    b = jnp.ones((NB * 8, 4), jnp.float64)
    f = lambda bc: trsm_factor_dist(bc, b, trans=trans)
    c = _counts(_lower(_bc(mesh, 8), f))
    assert c["all_reduce"] == 2 and c["all_gather"] == 0
    big = jnp.ones((NB * 16, 4), jnp.float64)
    c2 = _counts(_lower(_bc(mesh, 16),
                        lambda bc: trsm_factor_dist(bc, big, trans=trans)))
    assert c2 == c


# --- lauum: the one-shot design — exactly ONE collective total. ------

def test_lauum_dist_schedule_is_one_psum(mesh):
    c = _counts(_lower(_bc(mesh, 8), lambda b: lauum_dist(b).local))
    assert c["all_reduce"] == 1
    assert sum(c.values()) == 1
    c2 = _counts(_lower(_bc(mesh, 16), lambda b: lauum_dist(b).local))
    assert c2 == c


# --- trtri: per step 1 diag psum + 1 rhs all_gather + the inner solve
# loop's 2 psums, plus the info vma seed. ------------------------------

def test_trtri_dist_schedule(mesh):
    f = lambda b: trtri_dist(b, tiles="ref")
    c = _counts(_lower(_bc(mesh, 8), f))
    assert c["all_gather"] == 1 and c["all_reduce"] == 4
    assert _counts(_lower(_bc(mesh, 16), f)) == c


def test_potri_dist_schedule_is_composition(mesh):
    # potri = trtri ∘ lauum: schedules add (reference spotri.c:48-69).
    c = _counts(_lower(_bc(mesh, 8), potri_dist))
    assert c["all_gather"] == 1 and c["all_reduce"] == 5


def test_logdet_dist_schedule(mesh):
    # potrf(default phases=4) + one final scalar psum.
    c = _counts(_lower(_bc(mesh, 8), lambda b: logdet_dist(b, tiles="ref")))
    assert c["all_gather"] == 4 and c["all_reduce"] == 7
