"""Rules of the PyTorch port that hold on any machine: it imports neither
JAX nor the JAX package nor the libraries the card's machine lacks, its
smoke script's model literals are the smoke config's, and the smoke
script refuses to run without a card or outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "craniofacialsd_vae_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "craniofacialsd_vae_tpu",
             "yaml", "msgpack", "matplotlib", "sklearn", "pandas",
             "tensorboardX", "openpyxl", "PIL", "imageio", "seaborn")


def _port_files():
    files = [SMOKE]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


# The reference's sklearn pickles are written by these functions alone
# (no path on the card reaches them), which import sklearn where they run.
SKLEARN_ONLY_IN = {os.path.join(PKG, "analysis", "classifiers.py"):
                   {"to_sklearn"}}


def _absolute_imports(path):
    """(module, name of the enclosing function or None) of every absolute
    import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, func
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, func
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            yield from walk(child, inner)

    yield from walk(tree, None)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m, func in _absolute_imports(p)
           if m.split(".")[0] in FORBIDDEN
           and not (m.split(".")[0] == "sklearn"
                    and func in SKLEARN_ONLY_IN.get(p, ()))]
    assert not bad, bad
    allowed = [(p, m) for p in SKLEARN_ONLY_IN
               for m, func in _absolute_imports(p)
               if m.split(".")[0] == "sklearn"]
    assert allowed, "the sklearn exports moved: update SKLEARN_ONLY_IN"


def test_smoke_model_literals_equal_the_smoke_config():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configurations", "smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.MODEL_CONFIG == cfg["model"]
    assert chip_smoke.KL_WEIGHT == float(cfg["optimization"]["kl_weight"])
    assert chip_smoke.TO_MM == cfg["data"]["to_mm_constant"]
    # the training phase's literals (a YAML loader reads 1e-4 as a str)
    opt = cfg["optimization"]
    train = chip_smoke.TRAIN_CONFIG
    assert set(train) <= set(opt)
    assert {k: float(v) for k, v in train.items()} == \
        {k: float(opt[k]) for k in train}
    assert train["batch_size"] == opt["batch_size"]
    assert cfg["data"]["swap_features"] is True


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_smoke_fails_without_a_card():
    _assert_refused(_run_smoke(REPO, SMOKE))


def test_smoke_fails_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    _assert_refused(_run_smoke(str(tmp_path), str(alone)))


@pytest.mark.parametrize("name", ["ell_matmul.cu", "raster_sweep.cu",
                                  "spiral_conv.cu", "spiral_conv_dw.cu",
                                  "distances.cu", "spiral_conv_dx.cu",
                                  "sinkhorn.cu"])
def test_kernel_sources_export_their_c_entry_points(name):
    """Each kernel source exports the C function its ctypes binding
    declares, and names the JAX function it replaces."""
    from craniofacialsd_vae_tpu_torch import kernels

    assert name in kernels.SOURCES
    with open(os.path.join(PKG, "csrc", name)) as f:
        src = f.read()
    entries = {"ell_matmul.cu": ("cfs_ell_matmul_fwd",
                                 "cfs_ell_matmul_capped"),
               "raster_sweep.cu": ("cfs_raster_sweep",),
               "spiral_conv.cu": ("cfs_spiral_conv_fwd",),
               "spiral_conv_dw.cu": ("cfs_spiral_conv_dw",),
               "distances.cu": ("cfs_nearest_sq",
                                "cfs_nearest_sq_bwd"),
               "spiral_conv_dx.cu": ("cfs_spiral_conv_dx",),
               "sinkhorn.cu": ("cfs_sinkhorn_fwd", "cfs_sinkhorn_bwd")}[name]
    for entry in entries:
        assert f'extern "C" int {entry}(' in src
    assert "craniofacialsd_vae_tpu/" in src and "Replaces" in src


@pytest.mark.parametrize("module", ["training", "data", "geometry", "models",
                                    "ops", "serving", "utils", "viz",
                                    "manager", "train", "analysis", "serve",
                                    "test", "batch_diagnose",
                                    "visualize_in_batch"])
def test_port_modules_import_with_jax_blocked(module):
    """Each subpackage and entry module imports in a fresh process in
    which JAX, the JAX package and the libraries the card's machine lacks
    cannot be imported at all."""
    blocked = FORBIDDEN
    code = (f"import sys; sys.modules.update(dict.fromkeys({blocked!r})); "
            f"import craniofacialsd_vae_tpu_torch.{module}")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert any(os.path.relpath(p, PKG).startswith(module)
               for p in _port_files() if p != SMOKE)
