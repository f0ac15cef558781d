"""``python -m craniofacialsd_vae_tpu_torch.visualize_in_batch`` against
the root ``visualize_in_batch.py`` on a coloured octasphere template, on
the CPU: the 16 PLYs byte-equal (the swap is a select, exact in both)."""

import os
import sys

import pytest
import torch

from craniofacialsd_vae_tpu_torch import visualize_in_batch as tviz


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    from craniofacialsd_vae_tpu_torch.geometry import write_ply
    from craniofacialsd_vae_tpu_torch.geometry.synthetic import \
        synthetic_template

    tpl = synthetic_template(subdivisions=2, n_regions=3)
    path = str(tmp_path_factory.mktemp("tpl") / "template.ply")
    write_ply(path, tpl.pos, tpl.face, tpl.colors)
    return path


@pytest.mark.parametrize("region", [0, 1])
def test_plys_equal_the_root_scripts(template, tmp_path, monkeypatch,
                                     region):
    import visualize_in_batch as root
    from craniofacialsd_vae_tpu.utils import runtime

    monkeypatch.setattr(runtime, "setup_jax", lambda **k: None)
    monkeypatch.setattr(sys, "argv", [
        "visualize_in_batch.py", "--template", template, "--region",
        str(region), "--out", str(tmp_path / "jax")])
    root.main()
    paths = tviz.main(["--template", template, "--region", str(region),
                       "--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.path.basename(p) for p in paths)
    assert len(names) == 16
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_defaults_to_the_card(template, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviz.main(["--template", template, "--out", str(tmp_path)])
