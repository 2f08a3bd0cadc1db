"""The flags this slice adds to the port's CLI against the JAX CLI's: the
same names, defaults, choices and ``nargs``; each reaches the config; and
``--global-batch-size`` gives the JAX ``config_from_args``'s per-shard batch
at one, two and four data shards (``--n-devices``, or the launcher's
``WORLD_SIZE`` in the port), refusing a non-divisible value with the same
message."""

import pytest

from tpu_ddp.cli.train import build_parser as jax_build_parser
from tpu_ddp.cli.train import config_from_args as jax_config_from_args
from tpu_ddp_torch.cli.train import build_parser, config_from_args

NEW = ("--optimizer", "--sync-bn", "--faithful-epoch-order", "--global-batch-size",
       "--n-devices", "--log-every-steps", "--cv-mode", "--prefetch-depth",
       "--prefetch-batches", "--download")


def _action(parser, flag):
    return next(a for a in parser._actions if flag in a.option_strings)


@pytest.mark.parametrize("flag", NEW)
def test_flag_matches_the_jax_cli(flag):
    got, want = _action(build_parser(), flag), _action(jax_build_parser(), flag)
    assert got.dest == want.dest
    assert got.default == want.default
    assert got.choices == want.choices
    assert got.nargs == want.nargs and type(got) is type(want)
    assert got.type == want.type


def test_new_flags_reach_the_config():
    args = build_parser().parse_args([
        "--optimizer", "lamb", "--sync-bn", "--faithful-epoch-order", "--n-devices", "1",
        "--log-every-steps", "7", "--prefetch-depth", "3", "--prefetch-batches", "4",
        "--download"])
    c = config_from_args(args)
    assert (c.optimizer, c.sync_bn, c.reshuffle_each_epoch, c.n_devices) == ("lamb", True, False, 1)
    assert (c.log_every_steps, c.prefetch_depth, c.prefetch_batches, c.download) == (7, 3, 4, True)
    d = config_from_args(build_parser().parse_args([]))
    assert (d.prefetch_depth, d.prefetch_batches, d.reshuffle_each_epoch, d.sync_bn) == (2, 0, True, False)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("gbs", [64, 96])
def test_global_batch_size_per_shard_as_jax(world, gbs, monkeypatch):
    argv = ["--device", "cpu", "--global-batch-size", str(gbs), "--n-devices", str(world)]
    want = jax_config_from_args(jax_build_parser().parse_args(argv)).per_shard_batch
    assert config_from_args(build_parser().parse_args(argv)).per_shard_batch == want
    monkeypatch.setenv("WORLD_SIZE", str(world))      # under the launcher
    argv = ["--device", "cpu", "--global-batch-size", str(gbs)]
    assert config_from_args(build_parser().parse_args(argv)).per_shard_batch == want
    assert want == gbs // world


def test_global_batch_size_refuses_a_remainder_with_the_jax_message():
    argv = ["--device", "cpu", "--global-batch-size", "30", "--n-devices", "4"]
    with pytest.raises(AssertionError) as jax_err:
        jax_config_from_args(jax_build_parser().parse_args(argv))
    with pytest.raises(ValueError) as port_err:
        config_from_args(build_parser().parse_args(argv))
    assert str(port_err.value) == str(jax_err.value) == "global batch 30 not divisible by 4 data shards"
