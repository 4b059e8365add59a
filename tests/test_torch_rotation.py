"""parc_torch.utils.rotation against parc_tpu.utils.rotation.

Every ported function runs on the same numpy inputs (random quats with
both signs of w, exp-maps including near-zero ones, vectors, angles) in
both packages. Tolerance 1e-5 (f32 rounding of a handful of ops), and
2e-5 where a quat is turned into an angle through atan2 (the tolerance
the JAX package pins for its own quat -> exp-map port,
tests/test_pallas.py:36).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from parc_tpu.utils import rotation as jrot
from parc_torch.utils import rotation as trot

from test_torch_diffusion import jit

torch.set_num_threads(1)

N = 64


def _inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:4] = [[0, 0, 0, 1], [0, 0, 0, -1], [1e-7, 0, 0, 1], [0, 0, 1, 0]]
    q2 = rng.normal(size=(N, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    e = rng.normal(0, 1.0, size=(N, 3)).astype(np.float32)
    e[:3] = [[0, 0, 0], [1e-7, 0, 0], [0, 4.0, 0]]
    v = rng.normal(size=(N, 3)).astype(np.float32)
    v2 = rng.normal(size=(N, 3)).astype(np.float32)
    v2[0] = -v[0]  # antiparallel branch of quat_diff_vec
    a = rng.uniform(-6, 6, size=(N,)).astype(np.float32)
    b = rng.uniform(-3, 3, size=(N,)).astype(np.float32)
    c = rng.uniform(-3, 3, size=(N,)).astype(np.float32)
    t = rng.uniform(0, 1, size=(N,)).astype(np.float32)
    tn = rng.normal(size=(N, 6)).astype(np.float32)
    qn = (q + 1e-3 * rng.normal(size=(N, 4))).astype(np.float32)  # near q
    mat = np.array(jrot.quat_to_matrix(jnp.asarray(q)))
    return dict(q=q, q2=q2, e=e, v=v, v2=v2, a=a, b=b, c=c, t=t, tn=tn,
                qn=qn, mat=mat, v2d=v[:, :2].copy())


# name -> (argument keys, extra python args, atol)
CASES = {
    "normalize_angle": (("a",), (), 1e-5),
    "normalize": (("v",), (), 1e-5),
    "normalize_exp_map": (("e",), (), 2e-5),
    "quat_unit": (("q",), (), 1e-5),
    "quat_conjugate": (("q",), (), 1e-5),
    "quat_pos": (("q",), (), 1e-5),
    "quat_normalize": (("q",), (), 1e-5),
    "quat_abs": (("q",), (), 1e-5),
    "quat_mul": (("q", "q2"), (), 1e-5),
    "quat_rotate": (("q", "v"), (), 1e-5),
    "quat_rotate_inverse": (("q", "v"), (), 1e-5),
    "quat_inv": (("q",), (), 1e-5),
    "quat_diff": (("q", "q2"), (), 1e-5),
    "quat_diff_angle": (("q", "q2"), (), 2e-5),
    "axis_angle_to_quat": (("v", "a"), (), 1e-5),
    "quat_to_axis_angle": (("q",), (), 2e-5),
    "quat_to_exp_map": (("q",), (), 2e-5),
    "axis_angle_to_exp_map": (("v", "a"), (), 1e-5),
    "exp_map_to_axis_angle": (("e",), (), 1e-5),
    "exp_map_to_quat": (("e",), (), 1e-5),
    "quat_to_matrix": (("q",), (), 1e-5),
    "matrix_to_quat": (("mat",), (), 1e-5),
    "matrix_to_exp_map": (("mat",), (), 2e-5),
    "quat_to_tan_norm": (("q",), (), 1e-5),
    "tan_norm_to_matrix": (("tn",), (), 1e-5),
    "tan_norm_to_quat": (("tn",), (), 1e-5),
    "slerp": (("q", "q2", "t"), (), 1e-5),
    "calc_heading": (("q",), (), 2e-5),
    "heading_to_quat": (("a",), (), 1e-5),
    "calc_heading_quat": (("q",), (), 1e-5),
    "calc_heading_quat_inv": (("q",), (), 1e-5),
    "quat_from_euler_xyz": (("a", "b", "c"), (), 1e-5),
    "euler_xyz_to_exp_map": (("a", "b", "c"), (), 2e-5),
    "quat_integrate_angular_velocity": (("v", "q"), (0.1,), 1e-5),
    # the exp-map of a small rotation divided by dt = 0.5
    "quat_differentiate_angular_velocity": (("qn", "q"), (0.5,), 4e-5),
    "rotate_2d_vec": (("v2d", "a"), (), 1e-5),
    "heading_angle_from_xy": (("a", "b"), (), 1e-5),
    "quat_diff_vec": (("v", "v2"), (), 1e-5),
    "rotate_quat_by_heading": (("a", "q"), (), 1e-5),
    "rotate_exp_map_by_heading": (("a", "e"), (), 2e-5),
}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def test_every_function_is_covered():
    public = {n for n in dir(jrot) if not n.startswith("_")
              and callable(getattr(jrot, n)) and n not in ("annotations",)}
    public -= {"jax", "jnp"}
    assert public <= set(CASES), sorted(public - set(CASES))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name, inputs):
    keys, extra, atol = CASES[name]
    args = [inputs[k] for k in keys]
    want = jit(lambda *a: getattr(jrot, name)(*a, *extra))(
        *[jnp.asarray(a) for a in args])
    got = getattr(trot, name)(*[torch.as_tensor(a) for a in args], *extra)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=name)
