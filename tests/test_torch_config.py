"""pymbar_tpu_torch.config: the kernels' build directory under
PYMBAR_TPU_TORCH_CACHE_DIR, the counterpart of PYMBAR_TPU_CACHE_DIR."""

from pathlib import Path

import pytest

from pymbar_tpu_torch import config
from pymbar_tpu_torch.ops import _build


@pytest.mark.parametrize("value", [None, "", "kernels"])
def test_build_dir(monkeypatch, tmp_path, value):
    """pymbar_tpu_torch/_build/ unless PYMBAR_TPU_TORCH_CACHE_DIR names
    another directory (unset and empty both mean the default)."""
    default = Path(config.__file__).resolve().parent / "_build"
    if value is None:
        monkeypatch.delenv("PYMBAR_TPU_TORCH_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("PYMBAR_TPU_TORCH_CACHE_DIR", str(tmp_path / value) if value else "")
    assert config.build_dir() == (tmp_path / value if value else default)


def test_build_writes_to_the_override(monkeypatch, tmp_path):
    """A build writes its log into the overriding directory."""
    monkeypatch.setenv("PYMBAR_TPU_TORCH_CACHE_DIR", str(tmp_path / "kernels"))

    def fake_nvcc():
        return "/bin/false"  # the build fails at once, after its log is written

    monkeypatch.setattr(_build, "_nvcc", fake_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build("wsum")
    assert (tmp_path / "kernels" / "wsum.log").exists()
    assert not list((tmp_path / "kernels").glob("*.so"))

