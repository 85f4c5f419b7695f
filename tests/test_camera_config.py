import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vo.core.camera import CameraInfo
from stereo_vo.core.config import available_configs, load_config


def test_all_nine_reference_configs_present():
    # Parity with reference config/*.yaml (SURVEY.md C8)
    expected = {"kitti00", "kitti03", "kitti08", "kitti09", "kitti10", "kitti13",
                "d435i", "r200", "multisense"}
    assert expected.issubset(set(available_configs()))


@pytest.mark.parametrize(
    "name,focal,baseline",
    [
        ("kitti00", 718.856, 0.537165718864418),
        ("kitti03", 721.5377, 0.537150588250621),
        ("kitti08", 707.0912, 0.53715065326),
        ("kitti13", 718.856, 0.537165718864418),
        ("d435i", 385.7544860839844, 0.05),
        ("r200", 554.3826904296875, 0.07),
        ("multisense", 476.7030836014194, 0.07),
    ],
)
def test_config_values(name, focal, baseline):
    cfg = load_config(name)
    assert cfg.camera.focal == pytest.approx(focal)
    assert cfg.camera.baseline == pytest.approx(baseline)
    # reference compile-time constants surfaced in the typed config
    assert cfg.backend.window_size == 5
    assert cfg.backend.max_features == 400
    assert cfg.frontend.max_detect == 300
    assert cfg.frontend.parallax_thresh == 20.0


def test_config_is_hashable_static():
    cfg = load_config("kitti00")
    hash(cfg)  # must be usable as a jit static argument


def test_overrides():
    cfg = load_config("kitti00", overrides={"backend": {"window_size": 8}})
    assert cfg.backend.window_size == 8
    assert cfg.camera.focal == pytest.approx(718.856)


def test_project_backproject_roundtrip():
    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    uv = jnp.array([[100.0, 50.0], [600.0, 180.0]])
    disp = jnp.array([12.0, 3.5])
    p = cam.back_project(uv, disp)
    np.testing.assert_allclose(cam.project(p), uv, atol=1e-3)
    # depth = f*b/d
    np.testing.assert_allclose(p[:, 2], cam.focal * cam.baseline / disp, rtol=1e-6)


def test_backproject_matches_q_matrix():
    """back_project must equal dehomogenized Q @ [u v d 1] (image_processor.cpp:191-207)."""
    cam = CameraInfo(focal=500.0, cx=320.0, cy=240.0, baseline=0.1)
    q = cam.reprojection_q()
    uv = jnp.array([[123.0, 210.0]])
    d = jnp.array([7.0])
    vec = jnp.array([123.0, 210.0, 7.0, 1.0])
    hp = q @ vec
    np.testing.assert_allclose(
        cam.back_project(uv, d)[0], hp[:3] / hp[3], rtol=1e-5
    )


# Every key of every bundled camera file, as written there.
BUNDLED = {
    "kitti00": (718.856, 607.1928, 185.2157, 0.537165718864418, "/leftImage", "/rightImage", 11),
    "kitti03": (721.5377, 609.5593, 172.854, 0.537150588250621, "/leftImage", "/rightImage", 11),
    "kitti08": (707.0912, 601.8873, 183.1104, 0.53715065326, "/leftImage", "/rightImage", 11),
    "kitti09": (707.0912, 601.8873, 183.1104, 0.53715065326, "/leftImage", "/rightImage", 11),
    "kitti10": (707.0912, 601.8873, 183.1104, 0.53715065326, "/leftImage", "/rightImage", 11),
    "kitti13": (718.856, 607.1928, 185.2157, 0.537165718864418, "/leftImage", "/rightImage", 11),
    "d435i": (385.7544860839844, 323.1204833984375, 236.7432098388672, 0.05,
              "/camera/infra1/image_rect_raw", "/camera/infra2/image_rect_raw", 30),
    "r200": (554.3826904296875, 320, 240, 0.07, "/snake_r200/camera/ir/image_raw",
             "/snake_r200/camera/ir2/image_raw", 30),
    "multisense": (476.7030836014194, 400.5, 400.5, 0.07,
                   "/multisense_sl/camera/left/image_raw",
                   "/multisense_sl/camera/right/image_raw", 30),
}


@pytest.mark.parametrize("name", sorted(BUNDLED))
def test_camera_file_reader(name):
    """The YAML-free reader recovers every field of each bundled file."""
    from stereo_vo.core.config import CONFIG_DIR, _read_camera_file

    raw = _read_camera_file(f"{CONFIG_DIR}/{name}.yaml")
    keys = ("focal_length", "cx", "cy", "baseline", "left_topic", "right_topic",
            "frame_rate")
    assert raw == dict(zip(keys, BUNDLED[name]))
    cfg = load_config(name)
    assert (cfg.camera.focal, cfg.left_topic, cfg.frame_rate) == (
        BUNDLED[name][0], BUNDLED[name][4], float(BUNDLED[name][6]))


def test_camera_file_sections_and_comments(tmp_path):
    path = tmp_path / "cam.yaml"
    path.write_text(
        "# a rig\nfocal_length: 500.0  # px\ncx: 320\ncy: 240\nbaseline: 0.1\n"
        "left_topic: '/l'\n\nbackend:\n  window_size: 7\n  lam_warm_start: false\n"
        "frontend:\n  quality_level: 0.05\n"
    )
    cfg = load_config(str(path))
    assert cfg.camera.focal == 500.0 and cfg.left_topic == "/l"
    assert cfg.backend.window_size == 7 and cfg.backend.lam_warm_start is False
    assert cfg.frontend.quality_level == 0.05
    assert cfg.right_topic == "/rightImage"     # default kept
