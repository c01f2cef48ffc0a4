"""The torch port's config mirrors the JAX package's knobs."""

import dataclasses

import pytest
import torch

from neurondb_tpu import config as JC
from neurondb_tpu_torch import config as TC


@pytest.fixture()
def fresh_config(monkeypatch):
    """A process config rebuilt from the environment, restored after."""
    monkeypatch.setattr(TC, "_config", None)
    yield
    TC.set_config(None)


def test_same_fields_plus_device():
    jf = {f.name for f in dataclasses.fields(JC.NDBConfig)}
    tf = {f.name for f in dataclasses.fields(TC.NDBConfig)}
    # ivf_kernel is the JAX package's env var NEURONDB_TPU_IVF_KERNEL
    assert tf == jf | {"device", "ivf_kernel"}
    # every default mirrors the JAX value, packed selection included
    differ = {n for n in jf
              if getattr(TC.NDBConfig(), n) != getattr(JC.NDBConfig(), n)}
    assert differ == set()
    assert TC.NDBConfig().ivf_select == "packed"
    assert TC.NDBConfig().ivf_kernel == "grouped"


def test_show_set_reset_configure(fresh_config):
    cfg = TC.get_config()
    cfg.set("neurondb.ivf_nprobe", "25")            # string coerced to int
    assert cfg.show("ivf_nprobe") == 25
    cfg.reset("ivf_nprobe")
    assert cfg.ivf_nprobe == 10
    assert TC.configure(ivf_nlists=64, device="cpu") is cfg
    assert cfg.show("neurondb_tpu_torch.ivf_nlists") == 64
    with pytest.raises(AttributeError):
        cfg.show("no_such_knob")


def test_env_override_uses_torch_prefix(fresh_config, monkeypatch):
    monkeypatch.setenv("NEURONDB_TORCH_IVF_NPROBE", "7")
    monkeypatch.setenv("NEURONDB_TORCH_METRICS_ENABLE", "off")
    monkeypatch.setenv("NEURONDB_TPU_IVF_NLISTS", "999")     # the JAX prefix
    cfg = TC.get_config()
    assert cfg.ivf_nprobe == 7 and cfg.metrics_enable is False
    assert cfg.ivf_nlists == 100


def test_ivf_kernel_env_override(fresh_config, monkeypatch):
    """NEURONDB_TORCH_IVF_KERNEL sets the route; the JAX package's
    NEURONDB_TPU_IVF_KERNEL is not read."""
    monkeypatch.setenv("NEURONDB_TPU_IVF_KERNEL", "probe")
    assert TC.get_config().ivf_kernel == "grouped"
    TC.set_config(None)
    monkeypatch.setenv("NEURONDB_TORCH_IVF_KERNEL", "probe")
    cfg = TC.get_config()
    assert cfg.ivf_kernel == "probe"
    cfg.reset("ivf_kernel")
    assert cfg.ivf_kernel == "grouped"


def test_device_and_store_dtype_resolution(fresh_config):
    # the default is the card, whether or not one is present
    assert TC.NDBConfig().device == "cuda"
    assert TC.resolve_device() == torch.device("cuda")
    TC.configure(device="cpu")
    assert TC.resolve_device() == torch.device("cpu")
    assert TC.resolve_device("meta") == torch.device("meta")
    assert TC.resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert TC.resolve_store_dtype(torch.device("cpu")) == torch.float32
    assert TC.resolve_store_dtype(torch.device("cuda")) == torch.bfloat16
    assert TC.resolve_store_dtype(torch.device("cpu"), "bfloat16") == \
        torch.bfloat16
    with pytest.raises(ValueError, match="store_dtype"):
        TC.resolve_store_dtype(torch.device("cpu"), "int8")


def test_device_auto_raises(fresh_config):
    """No entry point picks the CPU on its own: "auto" names no device."""
    with pytest.raises(ValueError, match="auto"):
        TC.resolve_device("auto")
    TC.configure(device="auto")
    with pytest.raises(ValueError, match="cpu"):
        TC.resolve_device()
