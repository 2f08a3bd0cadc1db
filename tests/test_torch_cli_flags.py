"""The flags this slice adds to the port's CLI against the JAX CLI's: the
same names, defaults, choices and ``nargs``; each reaches the config; and
``--global-batch-size`` gives the JAX ``config_from_args``'s per-shard batch
at one, two and four data shards (``--n-devices``, or the launcher's
``WORLD_SIZE`` in the port), refusing a non-divisible value with the same
message. Sequence parallelism adds ``--parallelism``, ``--mesh`` and
``--sp-flash``: the same checks, ``--global-batch-size`` divided by the
mesh's data axis as the JAX CLI divides it, and the rank grid's
``parallel/mesh.py::resolve`` against ``MeshSpec.resolve`` (the sizes, or
the same error). Telemetry adds ``--telemetry-dir``, ``--telemetry-sinks``,
``--telemetry-snapshot-steps``, ``--watchdog-deadline``, ``--watchdog-abort``
and ``--no-data-digests`` (the same checks; each reaches ``TrainConfig``)
and the launcher's ``--telemetry-dir``."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import argparse

import pytest

from tpu_ddp.cli.train import build_parser as jax_build_parser
from tpu_ddp.cli.train import config_from_args as jax_config_from_args
from tpu_ddp_torch.cli.train import build_parser, config_from_args

NEW = ("--optimizer", "--sync-bn", "--faithful-epoch-order", "--global-batch-size",
       "--n-devices", "--log-every-steps", "--cv-mode", "--prefetch-depth",
       "--prefetch-batches", "--download", "--parallelism", "--mesh", "--sp-flash",
       "--telemetry-dir", "--telemetry-sinks", "--telemetry-snapshot-steps",
       "--watchdog-deadline", "--watchdog-abort", "--no-data-digests")


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
    t = config_from_args(build_parser().parse_args([
        "--telemetry-dir", "/tmp/t", "--telemetry-sinks", "jsonl", "--telemetry-snapshot-steps",
        "9", "--watchdog-deadline", "2.5", "--watchdog-abort", "--no-data-digests"]))
    assert (t.telemetry_dir, t.telemetry_sinks, t.telemetry_snapshot_steps) == ("/tmp/t", "jsonl", 9)
    assert (t.watchdog_deadline_seconds, t.watchdog_abort, t.data_digests) == (2.5, True, False)
    assert (d.telemetry_dir, d.telemetry_sinks, d.telemetry_snapshot_steps) == (
        None, "jsonl,chrome,summary", 50)
    assert (d.watchdog_deadline_seconds, d.watchdog_abort, d.data_digests) == (0.0, False, True)


@pytest.mark.parametrize("argv,message", [
    (["--telemetry-sinks", "jsonl,bogus"], "unknown telemetry sink 'bogus'"),
    (["--telemetry-snapshot-steps", "-1"], "telemetry_snapshot_steps must be >= 0"),
    (["--watchdog-abort"], "--watchdog-abort needs --watchdog-deadline > 0"),
])
def test_telemetry_guards_raise_the_jax_messages(argv, message):
    with pytest.raises(ValueError) as port_err:
        config_from_args(build_parser().parse_args(argv))
    with pytest.raises(ValueError) as jax_err:
        jax_config_from_args(jax_build_parser().parse_args(argv)).validate()
    assert str(port_err.value) == str(jax_err.value) and message in str(port_err.value)


def _launch_parser(main, monkeypatch):
    """The argparse parser a launcher's ``main`` makes (neither exposes one)."""
    class Built(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Built(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Built) as got:
            main([])
    return got.value.args[0]


def test_launcher_telemetry_dir_matches_the_jax_launcher(monkeypatch):
    from tpu_ddp.cli.launch import main as jax_launch
    from tpu_ddp_torch.cli.launch import main as port_launch

    got = _action(_launch_parser(port_launch, monkeypatch), "--telemetry-dir")
    want = _action(_launch_parser(jax_launch, monkeypatch), "--telemetry-dir")
    for key in ("dest", "default", "choices", "nargs", "type", "metavar"):
        assert getattr(got, key) == getattr(want, key), key


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


def test_sp_flags_reach_the_config():
    argv = ["--device", "cpu", "--parallelism", "sp", "--mesh", "data=2,sequence=2",
            "--sp-flash"]
    got = config_from_args(build_parser().parse_args(argv))
    want = jax_config_from_args(jax_build_parser().parse_args(argv))
    assert (got.parallelism, got.mesh, got.sp_flash) == (want.parallelism, want.mesh,
                                                         want.sp_flash) == (
        "sp", {"data": 2, "sequence": 2}, True)
    d = config_from_args(build_parser().parse_args([]))
    assert (d.parallelism, d.mesh, d.sp_flash) == (None, None, False)


@pytest.mark.parametrize("mesh", [["--mesh", "data=-1,sequence=2"], ["--mesh", "sequence=4"],
                                  ["--parallelism", "sp"], ["--mesh", "data=2,sequence=2"]],
                         ids=lambda m: " ".join(m))
def test_global_batch_size_under_a_mesh_as_jax(mesh):
    argv = ["--device", "cpu", "--global-batch-size", "64", "--n-devices", "4", *mesh]
    want = jax_config_from_args(jax_build_parser().parse_args(argv)).per_shard_batch
    assert config_from_args(build_parser().parse_args(argv)).per_shard_batch == want


@pytest.mark.parametrize("text,n", [
    ("data=2,sequence=2", 4), ("sequence=2", 8), ("data=-1,sequence=4", 8),
    ("data=1,sequence=2", 2), ("data=4", 4), ("data=3", 8), ("data=2,sequence=2", 8),
    ("data=-1,sequence=-1", 8), ("sequence=3", 8)])
def test_mesh_resolve_as_jax(text, n):
    from tpu_ddp.parallel.mesh import MeshSpec
    from tpu_ddp.train.strategy import parse_mesh_arg as jax_parse_mesh_arg
    from tpu_ddp_torch.parallel.mesh import resolve
    from tpu_ddp_torch.train.strategy import parse_mesh_arg

    sizes = parse_mesh_arg(text)
    assert sizes == jax_parse_mesh_arg(text)
    try:
        want = MeshSpec(**sizes).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve(sizes, n)
        assert str(got.value) == str(e)
        return
    assert resolve(sizes, n) == want


def test_mesh_unported_axis_raises():
    """No axis is left unported: the pipeline and expert axes resolve as
    ``MeshSpec.resolve`` does, and an unknown axis raises its message."""
    from tpu_ddp.parallel.mesh import MeshSpec
    from tpu_ddp_torch.parallel.mesh import resolve

    assert resolve({"data": 2, "pipeline": 2}, 4) == MeshSpec(data=2, pipeline=2).resolve(4)
    assert resolve({"expert": 2}, 4) == MeshSpec(expert=2).resolve(4)
    with pytest.raises(ValueError, match="unknown mesh axis 'stage'"):
        resolve({"stage": 2}, 4)
