"""SO(3) exp/log golden tests vs cv2.Rodrigues (SURVEY.md §4 unit strategy)."""

import cv2
import numpy as np
import pytest

from meatmodeler_tpu.geometry import so3


def rand_rvecs(n, scale=np.pi * 0.9, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * rng.uniform(1e-3, scale, size=(n, 1))


class TestExp:
    def test_matches_cv2_rodrigues(self):
        rvecs = rand_rvecs(64)
        ours = np.asarray(so3.exp(rvecs))
        for rvec, r in zip(rvecs, ours):
            expected = cv2.Rodrigues(rvec)[0]
            np.testing.assert_allclose(r, expected, atol=1e-6)

    def test_identity_at_zero(self):
        np.testing.assert_allclose(np.asarray(so3.exp(np.zeros(3))), np.eye(3), atol=1e-12)

    def test_small_angle_smooth(self):
        for eps in [1e-10, 1e-8, 1e-7, 1e-5]:
            rvec = np.array([eps, 0.0, 0.0])
            expected = cv2.Rodrigues(rvec)[0]
            np.testing.assert_allclose(np.asarray(so3.exp(rvec)), expected, atol=1e-9)

    def test_orthonormal(self):
        rvecs = rand_rvecs(32, seed=1)
        rs = np.asarray(so3.exp(rvecs))
        ident = np.einsum("nij,nkj->nik", rs, rs)
        np.testing.assert_allclose(ident, np.broadcast_to(np.eye(3), ident.shape), atol=1e-6)
        np.testing.assert_allclose(np.linalg.det(rs), 1.0, atol=1e-6)


class TestLog:
    def test_round_trip(self):
        rvecs = rand_rvecs(128)
        back = np.asarray(so3.log(so3.exp(rvecs)))
        np.testing.assert_allclose(back, rvecs, atol=1e-5)

    def test_matches_cv2(self):
        rvecs = rand_rvecs(32, seed=2)
        rs = np.asarray(so3.exp(rvecs))
        for r in rs:
            expected = cv2.Rodrigues(r)[0].ravel()
            np.testing.assert_allclose(np.asarray(so3.log(r)), expected, atol=1e-5)

    @pytest.mark.parametrize("angle", [np.pi - 1e-6, np.pi - 1e-3, np.pi])
    def test_near_pi(self, angle):
        rng = np.random.default_rng(3)
        for _ in range(8):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            rvec = axis * angle
            r = cv2.Rodrigues(rvec)[0]
            got = np.asarray(so3.log(r))
            # log is two-valued at pi: accept either sign.
            err = min(np.linalg.norm(got - rvec), np.linalg.norm(got + rvec))
            assert err < 1e-3, (angle, axis, got)

    def test_round_trip_matrix(self):
        """exp(log(R)) == R even where the rvec branch is ambiguous."""
        rvecs = rand_rvecs(32, scale=np.pi, seed=4)
        rs = np.asarray(so3.exp(rvecs))
        back = np.asarray(so3.exp(so3.log(rs)))
        np.testing.assert_allclose(back, rs, atol=1e-5)

    def test_batch_shapes(self):
        rvecs = rand_rvecs(12).reshape(3, 4, 3)
        assert so3.exp(rvecs).shape == (3, 4, 3, 3)
        assert so3.log(so3.exp(rvecs)).shape == (3, 4, 3)


import jax.numpy as jnp


class TestGradientsAtIdentity:
    """The BA Jacobian differentiates Rodrigues maps AT the identity — the
    anchor camera of every reconstruction has rvec exactly 0. sqrt(0)'s
    infinite derivative turned the whole LM camera gradient NaN through
    where-after-sqrt guards (the fix guards INSIDE the sqrt); this pins all
    three maps. Regression for the bug caught on-device by
    tests/test_gpu_device.py::test_global_ba_converges_on_device."""

    def test_exp_jacobian_finite_at_zero(self):
        import jax

        g = np.asarray(jax.jacobian(so3.exp)(jnp.zeros(3)))
        assert np.isfinite(g).all()
        # d exp / d rvec at 0 is the hat-map generator set.
        expect = np.asarray(jax.jacobian(so3.hat)(jnp.zeros(3)))
        np.testing.assert_allclose(g, expect, atol=1e-6)

    def test_log_jacobian_finite_at_identity(self):
        import jax

        g = np.asarray(jax.jacobian(so3.log)(jnp.eye(3)))
        assert np.isfinite(g).all()

    def test_project_points_jacobian_finite_at_identity_camera(self):
        import jax

        from meatmodeler_tpu.geometry import projection

        k = jnp.asarray([[500.0, 0, 200], [0, 500.0, 150], [0, 0, 1]])
        pts = jnp.asarray([[0.3, -0.2, 5.0]])

        def uv_of_cam(cam6):
            return projection.project_points(pts, cam6[None], k)[0]

        g = np.asarray(jax.jacobian(uv_of_cam)(jnp.zeros(6)))
        assert np.isfinite(g).all()
        # Finite-difference cross-check on the rotation block.
        eps = 1e-4
        for j in range(3):
            e = np.zeros(6, np.float32)
            e[j] = eps
            fd = (
                np.asarray(uv_of_cam(jnp.asarray(e)))
                - np.asarray(uv_of_cam(jnp.asarray(-e)))
            ) / (2 * eps)
            np.testing.assert_allclose(g[:, j], fd, rtol=1e-2, atol=1e-2)

    def test_log_jacobian_finite_at_axis_aligned_pi(self):
        """Axis-aligned half turns (R = diag(1,-1,-1) etc.) sit INSIDE the
        near-pi branch with two axis components exactly 0 and sin(theta)
        exactly 0 — both sqrt(0) sites must be guarded per component or the
        gradient NaNs (ADVICE r4; the identity-rotation fix alone left this
        case open)."""
        import jax

        for rots in (
            np.diag([1.0, -1.0, -1.0]),
            np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0]),
        ):
            g = np.asarray(jax.jacobian(so3.log)(jnp.asarray(rots)))
            assert np.isfinite(g).all(), rots
            # The value itself must still be the pi rotation about the axis.
            rv = np.asarray(so3.log(jnp.asarray(rots)))
            np.testing.assert_allclose(np.linalg.norm(rv), np.pi, atol=1e-5)
