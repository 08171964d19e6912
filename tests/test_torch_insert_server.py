"""The port's NGPServer over a real socket at 16x16: the handshake and all
14 actions of the viewer protocol, as the external OpenGL viewer sends
them, with a tiny insertor on the procedural scene (CPU, plain versions).
Frames are held to finiteness and shape here; their values are held to the
JAX package by tests/test_torch_insertor.py.
"""

import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import arnerf_tpu_torch.datasets as t_dsets
from arnerf_tpu_torch.datasets.synthetic import SyntheticConfig
from arnerf_tpu_torch.insert import main as t_main
from arnerf_tpu_torch.insert import sg_shadow as t_sg_shadow
from arnerf_tpu_torch.insert.sg_shadow import compute_fh_table
from arnerf_tpu_torch.models import grid_state_init
from tests.test_torch_insertor import make_hparams, sphere_occupancy

torch.set_num_threads(2)


class FakeViewer:
    """The viewer's side of the length-prefixed protocol."""

    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=60)

    def recv(self):
        n = int.from_bytes(self._recvn(8), "little")
        return self._recvn(n)

    def _recvn(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.s.recv(n - len(buf))
            assert chunk, "connection closed"
            buf += chunk
        return buf

    def send(self, payload):
        self.s.sendall(len(payload).to_bytes(8, "little") + payload)

    def action(self, aid, body=b""):
        self.send(struct.pack("i", aid) + body)

    def render(self, body=b""):
        self.action(6, body)
        assert struct.unpack("i", self.recv()) == (0,)  # render complete


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sphere_maps(h, w):
    """A normal/depth raster of a sphere filling an h x w bbox, as the
    viewer sends it (rows bottom-up)."""
    v, u = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                       indexing="ij")
    r2 = u ** 2 + v ** 2
    z = np.sqrt(np.clip(1 - r2, 0, 1))
    inside = r2 < 1
    nrm = np.stack([u, v, z], -1) * inside[..., None]
    depth = np.where(inside, 1.2 - 0.1 * z, 0.0)
    return np.concatenate([nrm, depth[..., None]], -1).astype(np.float32)


def _serve(ins):
    """NGPServer(ins) in a thread on a free port, and the viewer connected
    to it. Returns (thread, holder of the server, errors, viewer)."""
    port = _free_port()
    holder, errors = {}, []

    def serve():
        try:
            holder["srv"] = srv = t_main.NGPServer(ins, port=port)
            srv.run()
        except Exception as e:   # noqa: BLE001 - reported by the test
            errors.append(e)
            raise

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    for _ in range(200):
        try:
            return th, holder, errors, FakeViewer(port)
        except OSError:
            threading.Event().wait(0.05)
    raise AssertionError("the server did not listen")


def test_server_protocol_all_actions(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    orig = t_dsets.dataset_dict["synthetic"]
    monkeypatch.setitem(t_dsets.dataset_dict, "synthetic", lambda **kw: orig(
        config=SyntheticConfig(img_wh=(16, 16), n_train=2, n_test=1,
                               gt_samples=16), **kw))
    # a small F table keeps the SG-SSDF load quick
    fh = compute_fh_table(theta_num=32, lbd_num=64, zeta_num=16)
    monkeypatch.setattr(t_sg_shadow, "get_fh_table", lambda: fh)
    ins = t_main.NGPInsertor(make_hparams("srv"))
    ins.grid_state = grid_state_init(ins.cfg)._replace(
        occ_flat=torch.from_numpy(sphere_occupancy(ins.cfg.grid_size)))
    ins.blender_trans = np.eye(4, dtype=np.float32)
    ins.blender_scale = 1.0
    ins.env_opt.n_iter = 3
    ins.global_sh[0, 0] = 0.5

    # the viewer's mesh assets: an SG-SSDF PCA volume (torch .tar) and a
    # shadow-field export (.txt)
    rng = np.random.default_rng(0)
    torch.save({"coeff": torch.from_numpy(rng.normal(
                    0, 0.02, (20 ** 3, 128)).astype(np.float32)),
                "component": torch.from_numpy(rng.normal(
                    0, 0.05, (128, 74, 148)).astype(np.float32)),
                "mean": torch.full((1, 74, 148), 0.3)},
               tmp_path / "mesh.tar")
    np.savetxt(tmp_path / "mesh.txt",
               rng.normal(2.0, 0.3, (30 ** 3, 9)), fmt="%.4f")
    monkeypatch.setenv("VIEWER_SG_PATH", str(tmp_path))
    monkeypatch.setenv("VIEWER_SF_PATH", str(tmp_path))

    th, holder, errors, viewer = _serve(ins)

    # handshake: H, W, focal; blender transform; blender scale
    h, w, f = struct.unpack("iif", viewer.recv())
    assert (h, w) == (16, 16) and f == pytest.approx(float(ins.K[0, 0]))
    assert np.frombuffer(viewer.recv(), np.float32).shape == (16,)
    assert struct.unpack("f", viewer.recv()) == (1.0,)

    pose_gl = np.eye(4, dtype=np.float32)
    pose_gl[:3, 3] = [0.0, 0.1, 1.2]
    viewer.action(2, struct.pack("f" * 16, *pose_gl.flatten()))
    viewer.render()                  # info incomplete: plain NeRF frame
    viewer.action(9, b"mesh")        # SG-SSDF volume: SG pipeline
    viewer.action(14, struct.pack("fff", 0.4, 2.0, 0.1))
    rot = np.eye(3, dtype=np.float32)

    def move(mode, pos, bbox):
        viewer.action(1, struct.pack("ifff", mode, *pos) + rot.tobytes())
        (hs, ws), (hl, wl) = bbox
        maps = _sphere_maps(hl - hs, wl - ws)
        viewer.action(3, struct.pack("fiiii", 0.15, hs, ws, hl, wl)
                      + maps.tobytes())

    move(1, (0.0, 0.0, 0.0), [[4, 4], [10, 10]])
    viewer.render()                  # SG shade, self shadow, SSDF shadow
    move(1, (0.02, 0.0, 0.0), [[5, 4], [11, 10]])
    viewer.render()                  # dirty rect: union of the two bboxes
    viewer.action(10, struct.pack("i", 0))
    viewer.action(4, struct.pack("fffff", 0.3, 0.8, 0.5, 0.4, 0.3))
    tex = 8
    vp = np.eye(4, dtype=np.float32)
    viewer.action(7, struct.pack("i", tex) + struct.pack("f" * 16, *vp.ravel())
                  + rng.uniform(0, 1, (tex, tex)).astype(np.float32).tobytes())
    move(2, (0.0, 0.05, 0.0), [[4, 5], [10, 11]])
    assert np.frombuffer(viewer.recv(), np.float32).shape == (3,)  # light
    viewer.render()                  # rasterized shadow map
    viewer.render(struct.pack("i", 1) + b"saved")
    viewer.action(12)                # decomposition ablations
    for _ in range(3):
        assert struct.unpack("i", viewer.recv()) == (0,)
    viewer.action(13, struct.pack("i", 3))
    viewer.action(11)
    viewer.action(8, b"mesh")        # shadow field: SH pipeline
    viewer.action(5, struct.pack("fiiii", 0.15, 4, 4, 10, 10))
    move(1, (0.0, 0.0, 0.02), [[4, 4], [10, 10]])
    viewer.render()                  # neural-BRDF shade + shadow field
    viewer.action(0)
    th.join(timeout=120)
    assert not th.is_alive() and not errors

    srv = holder["srv"]
    assert srv.save_idx == 3 and srv.sg_use_self_shadow is False
    assert not srv.use_sg_base and srv.render_num == 9
    assert tuple(srv.sh.shape) == (1, 9, 3)
    assert float(srv.rough) == pytest.approx(0.3)
    assert srv.insertor.sg_shadow.delta_shadow_fac == pytest.approx(2.0)
    frame = srv.insertor.last_rgb
    assert tuple(frame.shape) == (16, 16, 3) and bool(torch.isfinite(frame)
                                                       .all())
    results = tmp_path / "insert" / "generate" / "srv" / "results"
    saved = sorted(p.name for p in (results / "cmp0").iterdir())
    assert saved == ["0_globalSH.png", "0_info.npz", "0_nerf_SG.png",
                     "0_nerf_no_any_shadow.exr", "0_nerf_no_any_shadow.png",
                     "0_nerf_no_globalSH.exr", "0_nerf_no_globalSH.png",
                     "0_nerf_no_self_shadow.exr", "0_nerf_no_self_shadow.png",
                     "0_saved.exr", "0_saved.png"]
    info = np.load(results / "cmp0" / "0_info.npz")
    assert info["rgb_HDR"].shape == (16, 16, 3)
    assert os.path.exists(tmp_path / "insert" / "generate" / "srv"
                          / "model_data" / "mesh.npz")


class _StubServer:
    """The JAX server's transport, without a socket: it keeps what the
    server sends."""

    def __init__(self, *a, **k):
        self.sent = []

    def send(self, message):
        self.sent.append(message)


def test_baked_server_frames_match_jax(tmp_path, monkeypatch):
    """ARNERF_INSERT_BAKED=1: the port's server behind the socket and the
    JAX server (its transport stubbed) take the same viewer messages, the
    camera, a shadow field (the SH pipeline) and two object moves (actions
    1, 3 and 6: the fast SH probe and the baked frame with the shadow
    field), on the same model, bake (JAX's, copied) and keys. Their
    frames agree to 1e-5 and both end with the same key."""
    import jax
    import arnerf_tpu.insert.main as j_main
    from tests.test_torch_baked import _to_port
    from tests.test_torch_insertor import FH_PRETAB, build_pair
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARNERF_INSERT_BAKED", "1")
    monkeypatch.setenv("ARNERF_INSERT_BAKE_RES", "32")
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(t_sg_shadow, "get_fh_table",
                        lambda: np.load(FH_PRETAB))
    j_ins, t_ins = build_pair(monkeypatch, img=16, n_train=2)
    t_ins._baked = _to_port(j_ins._get_baked())
    frames = {}
    for name, ins in (("jax", j_ins), ("port", t_ins)):
        ins.blender_trans = np.eye(4, dtype=np.float32)
        ins.blender_scale = 1.0
        ins.global_sh = ins.global_sh * 0 + 0.4
        frames[name] = []

        def keep(*a, _f=ins.render_insert_object, _out=frames[name], **k):
            _out.append(np.asarray(_f(*a, **k)))
            return _out[-1]
        ins.render_insert_object = keep
    np.savetxt(tmp_path / "mesh.txt", np.random.default_rng(0).normal(
        2.0, 0.3, (30 ** 3, 9)), fmt="%.4f")
    monkeypatch.setenv("VIEWER_SF_PATH", str(tmp_path))

    fused = []
    frame_fn = t_ins._frame_fused_fn
    t_ins._frame_fused_fn = lambda *a: fused.append(1) or frame_fn(*a)
    monkeypatch.setattr(j_main, "Server", _StubServer)
    j_srv = j_main.NGPServer(j_ins)
    th, holder, errors, viewer = _serve(t_ins)
    for _ in range(3):
        viewer.recv()                                # the handshake
    rot = np.eye(3, dtype=np.float32).tobytes()
    pose_gl = np.eye(4, dtype=np.float32)
    pose_gl[:3, 3] = [0.0, 0.1, 1.2]
    msgs = [(2, struct.pack("f" * 16, *pose_gl.ravel())), (8, b"mesh")]
    for pos, bbox in (((0.0, 0.0, 0.0), [[4, 4], [12, 12]]),
                      ((0.02, 0.0, 0.01), [[5, 3], [13, 11]])):
        (hs, ws), (hl, wl) = bbox
        msgs += [(1, struct.pack("ifff", 1, *pos) + rot),
                 (3, struct.pack("fiiii", 0.15, hs, ws, hl, wl)
                  + _sphere_maps(hl - hs, wl - ws).tobytes()),
                 (6, b"")]
    for aid, body in msgs:
        j_srv.act_dict[aid](body)
        if aid == 6:
            viewer.render(body)
        else:
            viewer.action(aid, body)
    viewer.action(0)
    th.join(timeout=120)
    assert not th.is_alive() and not errors
    assert not holder["srv"].use_sg_base and not j_srv.use_sg_base
    assert len(frames["port"]) == len(frames["jax"]) == len(fused) == 2
    for got, want in zip(frames["port"], frames["jax"]):
        assert got.shape == (16, 16, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(holder["srv"].sh.numpy(), np.asarray(j_srv.sh),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_ins.key, np.asarray(j_ins.key))
    assert not np.array_equal(j_ins.key, jax.random.PRNGKey(0))


SMALL_FLAGS = ["--dataset_name", "synthetic", "--grid_size", "32",
               "--n_levels", "4", "--log2_hashmap_size", "12"]


def _entry_point(tmp_path, drive, **env):
    """Run python -m arnerf_tpu_torch.insert.main --device cpu (16x16, no
    global SH) under `env`, connect a viewer, check the handshake, call
    drive(viewer), send action 0; returns the process's output."""
    import subprocess
    import sys
    import time
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="2", **env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "arnerf_tpu_torch.insert.main", "--device",
         "cpu", "--downsample", "0.125", "--exp_name", "cli",
         "--max_pc_pts_num", "500", "--no_global_SH", *SMALL_FLAGS],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        viewer, deadline = None, time.time() + 240
        while viewer is None and time.time() < deadline \
                and proc.poll() is None:
            for port in range(5001, 5006):
                try:
                    viewer = FakeViewer(port)
                    break
                except OSError:
                    continue
            time.sleep(0.2)
        assert viewer is not None, proc.communicate()[0]
        assert struct.unpack("iif", viewer.recv())[:2] == (16, 16)
        viewer.recv()
        viewer.recv()
        drive(viewer)
        viewer.action(0)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    gen = tmp_path / "insert" / "generate" / "cli"
    for name in ("pc.ply", "btrans.npy", "surface.npy"):
        assert (gen / name).exists()
    assert "jax" not in out.lower()
    return out


def test_insert_entry_point_serves_on_cpu(tmp_path):
    """python -m arnerf_tpu_torch.insert.main --device cpu: the prep
    (surface cache, point cloud) and the server, which answers a viewer
    until it sends action 0."""
    def drive(viewer):
        viewer.action(2, struct.pack("f" * 16, *np.eye(4, dtype=np.float32)
                                     .ravel()))
        viewer.render()
    _entry_point(tmp_path, drive)


def test_insert_entry_point_serves_baked_on_cpu(tmp_path):
    """ARNERF_INSERT_BAKED=1 python -m arnerf_tpu_torch.insert.main
    --device cpu: an object move bakes the field (16^3 here) for its SG
    probe, and a frame is served."""
    def drive(viewer):
        viewer.action(2, struct.pack("f" * 16, *np.eye(4, dtype=np.float32)
                                     .ravel()))
        viewer.action(1, struct.pack("ifff", 0, 0.0, 0.0, 0.0)
                      + np.eye(3, dtype=np.float32).tobytes())
        viewer.render()
    out = _entry_point(tmp_path, drive, ARNERF_INSERT_BAKED="1",
                       ARNERF_INSERT_BAKE_RES="16")
    assert "insert: baked 16^3 probe field" in out


def test_insert_entry_point_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_main.main(SMALL_FLAGS)
    # rtmv is ported: its loader refuses a scene prepare_rtmv has not
    # converted
    from arnerf_tpu_torch.datasets.captures import write_rtmv_capture
    write_rtmv_capture(str(tmp_path / "rtmv"), n_frames=2)
    with pytest.raises(FileNotFoundError, match="prepare_rtmv"):
        t_main.main(["--dataset_name", "rtmv", "--root_dir",
                     str(tmp_path / "rtmv"), "--device", "cpu"])


def test_decoders_read_the_viewer_bytes_as_the_jax_server():
    """The byte layouts of actions 2, 3 (both raster layouts), 4, 5, 7, 10
    and 14, the rows the viewer sends bottom-up and the GL-to-NeRF pose
    flip, against the JAX package's NGPServer on the same buffers."""
    import types
    from arnerf_tpu.insert.main import NGPServer as JServer
    rng = np.random.default_rng(1)
    ins = types.SimpleNamespace(device=torch.device("cpu"),
                                sg_shadow=types.SimpleNamespace())
    ins._t = lambda x, dtype=torch.float32: torch.as_tensor(x, dtype=dtype)
    j_srv, t_srv = object.__new__(JServer), object.__new__(t_main.NGPServer)
    for srv in (j_srv, t_srv):
        srv.insertor, srv.model_bbox, srv.vw = ins, None, None
    h, w = 5, 7
    bufs = [
        (2, struct.pack("f" * 16, *rng.normal(size=16))),
        (3, struct.pack("fiiii", 0.2, 3, 4, 3 + h, 4 + w)
         + rng.normal(size=h * w * 4).astype(np.float32).tobytes()),
        (4, struct.pack("fffff", 0.3, 0.8, 0.5, 0.4, 0.3)),
        (3, struct.pack("fiiii", 0.25, 1, 2, 1 + h, 2 + w)
         + rng.normal(size=h * w * 9).astype(np.float32).tobytes()),
        (5, struct.pack("fiiii", 0.3, 2, 3, 9, 11)),
        (7, struct.pack("i", 4) + struct.pack("f" * 16, *rng.normal(size=16))
         + rng.normal(size=16).astype(np.float32).tobytes()),
        (10, struct.pack("i", 1)),
        (14, struct.pack("fff", 0.5, 1.5, 0.2)),
    ]
    names = {2: "cam_pose_decoder", 3: "map_decoder", 4: "material_decoder",
             5: "shadow_field_decoder", 7: "shadow_map_decoder",
             10: "sg_use_sshadow", 14: "sg_shadow_facs_decoder"}
    for action, buf in bufs:
        for srv in (j_srv, t_srv):
            getattr(srv, names[action])(buf)
            if action == 14:     # the factors land on the shared object
                ins.got = (ins.sg_shadow.delta_angle_decay_fac,
                           ins.sg_shadow.delta_shadow_fac,
                           ins.sg_shadow.delta_self_shadow_fac)
        for attr in ("cam_pose", "normal", "depth", "albedo", "metal",
                     "rough", "model_radius", "model_bbox", "model_bbox_last",
                     "s_texSize", "s_VP", "s_im", "sg_use_self_shadow"):
            a, b = getattr(t_srv, attr, None), getattr(j_srv, attr, None)
            if b is None:
                assert a is None, attr
                continue
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{attr} after {action}")
    assert ins.got == pytest.approx((0.5, 1.5, 0.2))


def test_png_and_exr_files_read_back(tmp_path):
    """image_io's PNG (8-bit RGB) and OpenEXR (HALF RGB, ZIP) writers,
    read back by the JAX package's native decoder (libpng and OpenEXR's
    RGBA interface: the HALF values, 1e-3 relative)."""
    from arnerf_tpu.native import load_images_batch
    from arnerf_tpu_torch.image_io import write_exr, write_png
    rng = np.random.default_rng(2)
    hdr = rng.uniform(0, 4, (6, 9, 3)).astype(np.float32)
    ldr = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    write_exr(str(tmp_path / "a.exr"), hdr)
    write_png(str(tmp_path / "a.png"), ldr)
    got = load_images_batch([str(tmp_path / "a.exr"),
                             str(tmp_path / "a.png")], (9, 6))
    assert got is not None, "native decoder unavailable"
    np.testing.assert_allclose(got[0].reshape(6, 9, 3), hdr, rtol=1e-3,
                               atol=0)
    np.testing.assert_allclose(got[1].reshape(6, 9, 3), ldr / 255.0,
                               rtol=0, atol=1e-6)


def test_recorded_frames_are_numbered_pngs(tmp_path):
    """record=True keeps every served frame as a PNG under
    <gen_path>/record/ (the reference writes an OpenCV video; the port has
    no video encoder)."""
    from arnerf_tpu_torch.image_io import read_png
    srv = t_main.NGPServer.__new__(t_main.NGPServer)
    srv.record_dir, srv.render_num = str(tmp_path), 7
    rgb = np.linspace(-0.5, 1.5, 4 * 5 * 3).reshape(4, 5, 3)
    srv._display(torch.as_tensor(rgb))
    got = read_png(str(tmp_path / "frame_00007.png"))
    np.testing.assert_array_equal(
        got, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
