"""The port's copy of the wheel-odometry pose buffer against the JAX
package's: ``tests/test_aux.py::test_wheel_odom_pose_buffer``'s inputs,
replayed through both."""

import numpy as np

from ground_fusion_tpu.utils import wheel_odom as jw
from ground_fusion_tpu_torch.utils import wheel_odom as tw


def test_wheel_odom_pose_buffer_matches_jax():
    """Planar interpolation, out-of-span rejection, the 90° yaw case and
    ``init_frame_pose`` give the same arrays in both packages (and the
    oracle's values)."""
    np.testing.assert_array_equal(tw.WHEEL2CAM, jw.WHEEL2CAM)
    s = np.sqrt(0.5)
    runs = []
    for mod in (tw, jw):
        buf = mod.WheelOdomPoseBuffer(tio=np.zeros(3))
        for k in range(5):
            buf.push(0.1 * k, [0.5 * k, 0.0, 0.0], qz=0.0, qw=1.0)
        buf2 = mod.WheelOdomPoseBuffer()
        buf2.push(0.0, [0.0, 0.0, 0.0], qz=s, qw=s)
        buf2.push(1.0, [0.0, 1.0, 0.0], qz=s, qw=s)
        runs.append([buf.pose_by_wheel_odom(0.25), buf.pose_by_wheel_odom(-1.0),
                     buf.pose_by_wheel_odom(9.0), buf2.pose_by_wheel_odom(0.5),
                     buf.init_frame_pose(0.25, np.zeros(3), mod.WHEEL2CAM)])
    port, ref = runs
    assert port[1] is None and port[2] is None and ref[1] is None and ref[2] is None
    for i in (0, 3, 4):
        for a, b in zip(port[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port[0][0], [1.25, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(port[3][1] @ tw.WHEEL2CAM.T, [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                               atol=1e-12)
    np.testing.assert_allclose(port[4][1], np.eye(3), atol=1e-12)
