"""Data-parallel serving and the sharded fit of the port
(``DiagnosisService(data_parallel=True)``, ``fit_latent(mesh=)``,
``serve.py --data_parallel``) on the CPU, mirroring
``tests/test_serving.py``'s data-parallel service test and its
``--data_parallel`` server.

One process, two devices: the host's CPU named twice, so that the model
is replicated and every bucket's rows split between two replicas as they
would be between two cards. The run dir is the JAX-written one of
``tests/test_torch_diagnosis.py`` (``jax_run``), served by the JAX
package's single-device service as the reference.

Tolerances: against JAX's service the diagnosis tests' (latents and
meshes rtol 1e-5 of the largest value; the fit's latent 1e-3 absolute
and its losses rtol 1e-3 after 20 Adam steps); against the port's own
single-device service rtol 1e-5 (a replica runs its half of a bucket at
half the batch, where the host's BLAS may sum in another order), and at
one device the data-parallel service is the single-device service, bit
for bit."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from craniofacialsd_vae_tpu.serving import DiagnosisService as JService
from craniofacialsd_vae_tpu_torch import serve as tserve
from craniofacialsd_vae_tpu_torch.analysis import fitting as tfitting
from craniofacialsd_vae_tpu_torch.parallel import make_data_mesh
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
# jax_run: the fixture, imported so that pytest finds it here
from tests.test_torch_diagnosis import jax_run  # noqa: F401

MAX_BATCH = 4
TWO = ["cpu", "cpu"]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def services(jax_run):  # noqa: F811
    run = jax_run["run_dir"]
    j = JService.from_run_dir(run, max_batch=MAX_BATCH)
    one = DiagnosisService.from_run_dir(run, max_batch=MAX_BATCH,
                                        device="cpu")
    dp = DiagnosisService.from_run_dir(run, max_batch=MAX_BATCH,
                                       device="cpu", data_parallel=True,
                                       devices=TWO)
    for s in (j, one, dp):
        s.landmark_idx = jax_run["landmarks"]
    return j, one, dp


def test_buckets_and_stats(services):
    """Buckets are multiples of the devices; each device has its own
    replica and programs."""
    _, one, dp = services
    assert dp.n_devices == 2 and dp.buckets == [2, 4]
    assert dp.stats()["n_devices"] == 2
    assert one.stats()["n_devices"] == 1 and one.buckets == [1, 2, 4]
    assert dp._replicas[0] is dp.manager.model
    assert dp._replicas[1] is not dp.manager.model
    for a, b in zip(dp._replicas[0].parameters(),
                    dp._replicas[1].parameters()):
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())


@pytest.mark.parametrize("rows", [1, 3, 4, 5])
def test_encode_reconstruct_decode_match(jax_run, services, rows):  # noqa: F811
    """Every program over the two replicas against the single-device
    services (a batch of 5 runs as a bucket of 4, then one of 2 padded)."""
    js, one, dp = services
    raw = jax_run["raw"][:rows]
    mu = dp.encode(raw)
    assert mu.shape == (rows, 6)
    assert _rel(mu, one.encode(raw)) <= 1e-5
    assert _rel(mu, js.encode(raw)) <= 1e-5
    rec, rec1 = dp.reconstruct(raw), one.reconstruct(raw)
    for k in ("vertices", "vertex_errors_mm", "mean_error_mm", "latent"):
        assert _rel(rec[k], rec1[k]) <= 1e-5, k
    assert _rel(dp.decode(mu), one.decode(mu)) <= 1e-5
    assert _rel(dp.decode(mu), np.asarray(js.decode(mu))) <= 1e-5


def test_diagnose_and_plan_match(jax_run, services):  # noqa: F811
    js, one, dp = services
    raw = jax_run["raw"]
    for a, b in zip(dp.diagnose(raw[:3]), js.diagnose(raw[:3])):
        assert a["label"] == b["label"]
        assert _rel(a["latent"], b["latent"]) <= 1e-5
    assert dp.diagnose(raw[0])["label"] == one.diagnose(raw[0])["label"]
    p_dp, p_1 = dp.plan(vertices=raw[0]), one.plan(vertices=raw[0])
    for k in ("z_3std", "z_2std", "z_1std"):
        assert _rel(p_dp[k], p_1[k]) <= 1e-5, k
    for k, v in p_1["target_meshes"].items():
        assert _rel(p_dp["target_meshes"][k], v) <= 1e-5, k


def test_fit_splits_restarts(jax_run, services):  # noqa: F811
    """The restarts split over the devices, the best taken across them:
    the unsharded fit's answer (and JAX's, to the diagnosis tests'
    tolerance)."""
    js, one, dp = services
    lnd = jax_run["landmarks"]
    scan = jax_run["raw"][0] * 1.1
    got = dp.fit(scan, scan[lnd], iterations=20, n_restarts=4)
    ref = one.fit(scan, scan[lnd], iterations=20, n_restarts=4)
    want = js.fit(scan, scan[lnd], iterations=20, n_restarts=4)
    assert got["best_restart"] == ref["best_restart"]
    assert _rel(got["z"], ref["z"]) <= 1e-5
    assert got["chamfer_mm2"] == pytest.approx(ref["chamfer_mm2"], rel=1e-5)
    assert np.abs(got["z"] - want["z"]).max() <= 1e-3
    assert got["chamfer_mm2"] == pytest.approx(want["chamfer_mm2"], rel=1e-3)
    assert got["diagnosis"]["label"] == want["diagnosis"]["label"]


def test_fit_latent_rounds_restarts_up(jax_run, services):  # noqa: F811
    """Five restarts over two devices run as six: the unsharded fit of
    six restarts."""
    _, one, dp = services
    mgr = one.manager
    lnd = jax_run["landmarks"]
    scan = jax_run["raw"][1]
    mesh = make_data_mesh(devices=TWO)
    assert not mesh.ranks and mesh.size == 2
    got = tfitting.fit_latent(mgr, one.normalization, scan, scan[lnd], lnd,
                              iterations=3, n_restarts=5, mesh=mesh)
    six = tfitting.fit_latent(mgr, one.normalization, scan, scan[lnd], lnd,
                              iterations=3, n_restarts=6)
    assert got["best_restart"] == six["best_restart"]
    assert _rel(got["z"], six["z"]) <= 1e-5
    assert _rel(got["vertices"], six["vertices"]) <= 1e-5
    assert got["landmark_mse_mm2"] == pytest.approx(six["landmark_mse_mm2"],
                                                    rel=1e-5)


def test_one_device_is_the_single_service(jax_run, services):  # noqa: F811
    """data_parallel over one device: the single-device service's
    buckets, programs and answers, bit for bit."""
    _, one, _ = services
    dp1 = DiagnosisService.from_run_dir(jax_run["run_dir"],
                                        max_batch=MAX_BATCH, device="cpu",
                                        data_parallel=True, devices=["cpu"])
    dp1.landmark_idx = one.landmark_idx
    raw = jax_run["raw"][:3]
    assert dp1.n_devices == 1 and dp1.buckets == one.buckets
    np.testing.assert_array_equal(dp1.encode(raw), one.encode(raw))
    a, b = dp1.reconstruct(raw), one.reconstruct(raw)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    scan = raw[0] * 0.9
    lnd = one.landmark_idx
    fa = dp1.fit(scan, scan[lnd], iterations=3, n_restarts=3)
    fb = one.fit(scan, scan[lnd], iterations=3, n_restarts=3)
    np.testing.assert_array_equal(fa["z"], fb["z"])


def test_max_batch_must_tile_the_devices(jax_run):  # noqa: F811
    with pytest.raises(ValueError, match="multiple"):
        DiagnosisService.from_run_dir(jax_run["run_dir"], max_batch=3,
                                      device="cpu", data_parallel=True,
                                      devices=TWO)


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def test_http_over_two_devices(jax_run, services):  # noqa: F811
    """The HTTP server over the two-device service: its buckets in
    healthz, and a batched diagnose."""
    _, _, dp = services
    srv = tserve.make_server(dp, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        h = json.loads(urllib.request.urlopen(url + "/healthz",
                                              timeout=60).read())
        assert h["n_devices"] == 2 and h["buckets"] == [2, 4]
        out = _post(url, "/diagnose",
                    {"vertices": jax_run["raw"][:3].tolist()})
        assert len(out["reports"]) == 3
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_main_data_parallel(jax_run, monkeypatch):  # noqa: F811
    """``serve.py --data_parallel`` (here over the host's one device)
    answers over HTTP."""
    made = []
    real = tserve.make_server

    def spy(service, host, port):
        srv = real(service, host, port)
        made.append(srv)
        return srv

    monkeypatch.setattr(tserve, "make_server", spy)
    th = threading.Thread(target=tserve.main, args=([
        "--run_dir", jax_run["run_dir"], "--device", "cpu", "--port", "0",
        "--max_batch", "4", "--data_parallel", "--no_warmup"],),
        daemon=True)
    th.start()
    for _ in range(600):
        if made:
            break
        th.join(0.1)
    assert made, "the server never started"
    srv = made[0]
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        for _ in range(100):
            try:
                h = json.loads(urllib.request.urlopen(url + "/healthz",
                                                      timeout=60).read())
                break
            except OSError:
                th.join(0.1)
        assert h["n_devices"] == 1 and h["requests"] == 0
        out = _post(url, "/diagnose", {"vertices": jax_run["raw"][0].tolist()})
        assert out["reports"]["label"] in {"a", "c", "n"}
    finally:
        srv.shutdown()
        th.join(30)
