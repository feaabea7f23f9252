"""The port's ``utils``: ``fluidformat`` (round trips, and files written by
the JAX package's copy read back), ``native_io`` (the C++ loader built with
the host's g++, against ``np.load``; the smoke loader on it against the
JAX loader), ``profiling`` on the CPU and ``viz`` PNGs.

Tolerances: file contents exact; the smoke dataset to 1e-6 of max(1, |ref|)
(the native loader converts float64 arrays to float32 as it reads, before
the target-share division, which numpy does in float64 then casts: ~1 ulp).
"""

import json

import numpy as np
import pytest
import torch

from diffphycon_tpu.training.data import load_smoke_dataset as jax_load_smoke_dataset
from diffphycon_tpu.utils import fluidformat as jff
from diffphycon_tpu_torch.training.data import load_smoke_dataset
from diffphycon_tpu_torch.utils import fluidformat as ff
from diffphycon_tpu_torch.utils import native_io, profiling, viz
from torch_port_helpers import assert_close


def test_port_fluidformat_round_trip_and_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    dens, vel = rng.normal(size=(1, 8, 8, 1)), rng.normal(size=(1, 9, 9, 2))
    scene = ff.Scene.create(str(tmp_path), "sims")
    assert scene.index == 0 and ff.Scene.create(str(tmp_path), "sims").index == 1
    scene.properties = {"dt": 0.5}
    scene.write_sim_frame([dens, vel], ["Density", "Velocity"], 3)
    assert scene.properties == {"dt": 0.5}
    np.testing.assert_array_equal(scene.read_array("Density", 3), dens)
    assert ff.get_fieldnames(scene.path) == ["Density", "Velocity"]
    assert ff.get_indices(scene.path) == [3]
    assert ff.read_sim_frame(scene.path, ["Velocity", "Missing"], 3)[1] is None
    with pytest.raises(IOError):
        ff.read_sim_frame(scene.path, "Missing", 3, set_missing_to_none=False)
    # the JAX package's writer and the port's reader, and the other way round
    jscene = jff.Scene(str(tmp_path), "sims", 1)
    jscene.write_sim_frame([vel], ["Velocity"], 0)
    np.testing.assert_array_equal(ff.Scene(str(tmp_path), "sims", 1).read_array("Velocity", 0),
                                  vel)
    np.testing.assert_array_equal(jff.read_sim_frame(scene.path, "Velocity", 3), vel)
    assert [s.index for s in ff.Scene.list(str(tmp_path), "sims")] == \
        [s.index for s in jff.Scene.list(str(tmp_path), "sims")] == [0, 1]
    path = str(tmp_path / "a.npz")
    ff.write_zipped_array(path, dens)
    assert np.load(path)["arr_0"].shape == (8, 8, 1)  # stored without the batch dim
    np.testing.assert_array_equal(jff.read_zipped_array(path), ff.read_zipped_array(path))


def test_port_native_io_against_np_load(tmp_path):
    lib = native_io.build()
    assert lib.is_file() and "build/diffphycon_tpu_torch/native_io" in lib.as_posix()
    rng = np.random.default_rng(1)
    for dtype in (np.float32, np.float64, np.int64, np.float16):
        arrays = [(10 * rng.normal(size=(3, 5, 4))).astype(dtype) for _ in range(3)]
        paths = [tmp_path / f"{np.dtype(dtype).name}_{i}.npy" for i in range(3)]
        for p, a in zip(paths, arrays):
            np.save(p, a)
        assert native_io.npy_info(paths[0]) == ((3, 5, 4), dtype)
        out = native_io.load_npy_batch(paths, (3, 5, 4), n_threads=2)
        np.testing.assert_array_equal(out, np.stack([np.load(p).astype(np.float32)
                                                     for p in paths]))
    for save in (np.savez, np.savez_compressed):
        arrays = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2)]
        paths = [tmp_path / f"{save.__name__}_{i}.npz" for i in range(2)]
        for p, a in zip(paths, arrays):
            save(p, a=a, b=np.zeros(2))
        np.testing.assert_array_equal(native_io.load_npz_batch(paths, "a", (4, 6)),
                                      np.stack(arrays))
    fortran = tmp_path / "f.npy"
    np.save(fortran, np.asfortranarray(rng.normal(size=(3, 4))))
    with pytest.raises(OSError, match="native loader failed"):
        native_io.load_npy_batch([fortran], (3, 4))
    with pytest.raises(OSError, match="cannot read"):
        native_io.npy_info(tmp_path / "missing.npy")


def _smoke_sims(root, n=2, t=5, h=8):
    rng = np.random.default_rng(2)
    for i in range(n):
        d = root / "test" / "control" / f"sim_{i:06d}"
        d.mkdir(parents=True)
        np.save(d / "Density.npy", rng.random((h, h, 1, t)).astype(np.float32))
        np.save(d / "Velocity.npy", rng.normal(size=(h, h, 2, t)).astype(np.float32))
        np.save(d / "Control.npy", rng.normal(size=(h, h, 2, t)).astype(np.float32))
        np.save(d / "Smoke.npy", rng.random((t, 8)))  # float64, as numpy writes it


def test_port_smoke_loader_on_native_io_against_jax(tmp_path):
    _smoke_sims(tmp_path)
    out = load_smoke_dataset(str(tmp_path), "test")
    ref = jax_load_smoke_dataset(str(tmp_path), "test")
    assert out.shape == ref.shape == (2, 5, 8, 8, 6) and out.dtype == np.float32
    assert_close(out, ref, 1e-6)


def test_port_profiling_on_cpu(tmp_path):
    assert not profiling.recording()
    with profiling.span("sampler.ddpm_step") as off:
        assert off is None
    with profiling.trace(str(tmp_path / "tr")) as prof:
        assert profiling.recording()
        with profiling.span("sampler.ddpm_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not profiling.recording()
    names = [e.key for e in prof.key_averages()]
    assert "sampler.ddpm_step" in names
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "sampler.ddpm_step" for e in events)


def _is_png(path):
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_port_viz_writes_pngs(tmp_path):
    rng = np.random.default_rng(3)
    paths = [viz.save_field_png(torch.from_numpy(rng.normal(size=(16, 16, 1))),
                                str(tmp_path / "f.png"), title="x")]
    seq = viz.save_field_sequence(rng.normal(size=(2, 3, 8, 8, 1)), str(tmp_path), "Density",
                                  batches=[1])
    assert len(seq) == 3 and seq[0].endswith("Density_batch0001_0000.png")
    u, f = rng.normal(size=(2, 11, 128)), torch.from_numpy(rng.normal(size=(2, 10, 128)))
    paths += seq + [
        viz.plot_burgers_control(u, f, str(tmp_path / "b.png"), u_target=u[:, -1]),
        viz.plot_smoke_frames(rng.random((1, 8, 16, 16, 6)), str(tmp_path / "s.png"),
                              num_frames=4),
        viz.plot_jellyfish_result(rng.random((2, 20)), str(tmp_path / "j.png"),
                                  J_list=[3.0, 2.0], boundary=rng.random((2, 16, 16, 3))),
        viz.plot_metric_curves({"loss": [1.0, 0.5, 0.2]}, str(tmp_path / "m.png"), logy=True)]
    assert all(_is_png(p) for p in paths)
