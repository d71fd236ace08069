"""The port's checkpoint converter and `.tar` writer against the JAX
package's, on the CPU.

- `cli/convert_chkpt` of both packages on one seeded width-64 reference
  `.tar` (the JAX CLI has no --width: its model is width 64) write the
  same `.msgpack`, byte for byte, in fast mode untyped and in original
  mode typed;
- `models.checkpoints.save_torch_tar` of both packages, fed the same
  JAX variables, write the same keys, with and without DataParallel's
  'module.' prefix, and equal arrays;
- `.tar` -> `.msgpack` (the port's CLI) -> `.tar` (the port's
  `save_torch_tar`) gives back the state dict it started from.
"""

import numpy as np
import pytest
import torch

from hover_net_tpu.cli import convert_chkpt as jax_cli
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.models import checkpoints as jax_ckpt
from hover_net_tpu_torch.cli import convert_chkpt
from hover_net_tpu_torch.models import checkpoints as ckpt
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

# (mode, --nr_types; 0 is untyped)
CASES = [("fast", 0), ("original", 5)]
IDS = ["fast-untyped", "original-typed"]


def nr_types_of(n):
    return n if n > 0 else None


def write_reference_tar(path, mode, n):
    """A seeded w64 reference `.tar`: {'desc'} with the 'module.' prefix
    and num_batches_tracked, as the reference trainer writes it."""
    model = HoVerNet(HoVerNetConfig(mode=mode, nr_types=nr_types_of(n),
                                    width=64),
                     generator=torch.Generator().manual_seed(17))
    # BN statistics away from their 0 / 1 start
    rng = np.random.default_rng(17)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            buf.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    torch.save({"desc": {"module." + k: v
                         for k, v in model.state_dict().items()}}, path)


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    """{(mode, nr_types): path of its reference `.tar`}."""
    tmp = tmp_path_factory.mktemp("tars")
    out = {}
    for mode, n in CASES:
        out[mode, n] = str(tmp / f"{mode}_{n}.tar")
        write_reference_tar(out[mode, n], mode, n)
    return out


@pytest.fixture(params=CASES, ids=IDS)
def reference_tar(request, tars):
    """(mode, nr_types, path of its reference `.tar`)."""
    return request.param + (tars[request.param],)


def convert(main, tar, out, mode, n):
    main(["--input", tar, "--output", str(out), "--mode", mode,
          "--nr_types", str(n)])
    return out.read_bytes()


def test_convert_chkpt_bytes_match_jax_cli(reference_tar, tmp_path):
    mode, n, tar = reference_tar
    want = convert(jax_cli.main, tar, tmp_path / "jax.msgpack", mode, n)
    got = convert(convert_chkpt.main, tar, tmp_path / "port.msgpack", mode, n)
    assert len(got) > 100 << 20  # w64: ~144 MiB of float32
    assert got == want


@pytest.mark.parametrize("prefix", [True, False], ids=["module", "bare"])
def test_save_torch_tar_matches_jax(reference_tar, tmp_path, prefix):
    mode, n, tar = reference_tar
    jcfg = JaxConfig(mode=mode, nr_types=nr_types_of(n))
    variables = jax_ckpt.load_torch_tar(tar, jcfg)
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types_of(n))
    jax_ckpt.save_torch_tar(str(tmp_path / "jax.tar"), variables, jcfg,
                            data_parallel_prefix=prefix)
    ckpt.save_torch_tar(str(tmp_path / "port.tar"), variables, cfg,
                        data_parallel_prefix=prefix)
    want = torch.load(tmp_path / "jax.tar", weights_only=True)["desc"]
    got = torch.load(tmp_path / "port.tar", weights_only=True)["desc"]
    assert list(got) == list(want)
    assert all(k.startswith("module.") == prefix for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # the JAX package's exporter, called directly, gives the same arrays
    exported = ckpt.export_torch_state_dict(variables, cfg)
    for k, v in jax_ckpt.export_torch_state_dict(variables, jcfg).items():
        np.testing.assert_array_equal(exported[k], v)
    assert list(exported) == list(
        jax_ckpt.export_torch_state_dict(variables, jcfg))


def test_tar_msgpack_tar_round_trip(reference_tar, tmp_path):
    """Every variable of the model and the unpool buffer come back
    bit-identical; only num_batches_tracked (no JAX variable) is
    dropped."""
    mode, n, tar = reference_tar
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types_of(n))
    convert(convert_chkpt.main, tar, tmp_path / "m.msgpack", mode, n)
    variables, extra = ckpt.load_checkpoint(str(tmp_path / "m.msgpack"))
    assert extra == {"mode": mode, "nr_types": n, "source": tar}
    ckpt.save_torch_tar(str(tmp_path / "back.tar"), variables, cfg)
    start = ckpt.load_torch_tar(tar)
    back = ckpt.load_torch_tar(str(tmp_path / "back.tar"))
    assert sorted(set(start) - set(back)) == sorted(
        k for k in start if k.endswith("num_batches_tracked"))
    assert set(back) <= set(start)
    for k in back:
        assert torch.equal(back[k], start[k]), k
    # and the model loads it
    model = HoVerNet(HoVerNetConfig(mode=mode, nr_types=nr_types_of(n),
                                    width=64))
    missing, unexpected = model.load_state_dict(back, strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing)


@pytest.mark.parametrize("main", [jax_cli.main, convert_chkpt.main],
                         ids=["jax", "port"])
def test_convert_chkpt_refuses_a_missing_variable(tars, tmp_path, main):
    """Both CLIs refuse a `.tar` that lacks a variable of the asked model
    (the untyped `.tar` read as typed) and write nothing."""
    with pytest.raises(KeyError, match="missing torch key"):
        convert(main, tars["fast", 0], tmp_path / "x.msgpack", "fast", 5)
    assert not (tmp_path / "x.msgpack").exists()
