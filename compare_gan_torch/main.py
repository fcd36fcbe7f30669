"""Binary to train and evaluate GANs with the port (counterpart of
compare_gan_tpu/main.py).

Same flags as the JAX binary's --model_dir, --schedule, --gin_config,
--gin_bindings, --score_filename, --num_eval_averaging_runs,
--eval_every_steps, --data_fake_dataset, --num_devices, --multihost,
--coordinator_address, --num_processes, --process_id and --use_tpu
(accepted and ignored), plus --device (default cuda; there is no fallback
to the CPU). The eval schedules need Inception weights:
$COMPARE_GAN_INCEPTION_NPZ (the .npz that
`metrics.inception_net.convert_frozen_graph` writes) or
$COMPARE_GAN_INCEPTION_PB (the frozen graph itself).

Data parallelism runs one worker process per device, joined by
torch.distributed (NCCL for CUDA, gloo for the CPU):

* `--num_devices=N` trains on N devices of this host: N spawned workers
  with a localhost rendezvous (one worker runs in this process). The
  default is every local CUDA device, as the JAX binary's is every local
  device; with one device (or --device=cpu, or a pinned --device=cuda:1)
  the run is one process without a group. More devices than exist is an
  error, as in JAX.
* `--multihost --coordinator_address=host:port --num_processes=P
  --process_id=p`, run once on each of P hosts, makes this process host p
  of P: it starts its --num_devices local workers (default: every local
  CUDA device; one on the CPU), ranks p * N ... p * N + N - 1 of the
  group, whose rendezvous is at the coordinator's address.

Rank 0 writes every file and runs the eval schedules' evaluation. A worker
that fails fails the launch.

Example:
  python -m compare_gan_torch.main --model_dir=/tmp/gan \
      --gin_config=example_configs/biggan_imagenet128.gin --data_fake_dataset
  python -m compare_gan_torch.main --model_dir=/tmp/gan --num_devices=8 \
      --gin_config=example_configs/biggan_imagenet128.gin --data_fake_dataset
  python -m compare_gan_torch.main --model_dir=/tmp/gan \
      --schedule=eval_after_train --eval_every_steps=0 \
      --gin_config=example_configs/biggan_imagenet128.gin --data_fake_dataset
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import datasets, runner_lib
from compare_gan_torch.parallel import mesh_utils
# Importing registers the configurables the .gin files reference.
from compare_gan_torch import gans  # noqa: F401

logger = logging.getLogger(__name__)


def _bool(text):
    if text.lower() in ("1", "true", "yes"):
        return True
    if text.lower() in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(f"Not a boolean: {text!r}")


def _parser():
    p = argparse.ArgumentParser(prog="compare_gan_torch.main",
                                description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", required=True, help="Where to store files.")
    p.add_argument("--schedule", default="train",
                   help="Schedule to run: train, continuous_eval, "
                   "eval_after_train.")
    p.add_argument("--gin_config", action="append", default=[],
                   help="Path of a config file (repeatable).")
    p.add_argument("--gin_bindings", action="append", default=[],
                   help="A gin binding (repeatable).")
    p.add_argument("--score_filename", default="scores.csv",
                   help="Evaluation CSV in model_dir (eval schedules).")
    p.add_argument("--num_eval_averaging_runs", type=int, default=3,
                   help="How many times to average FID and IS.")
    p.add_argument("--eval_every_steps", type=int, default=5000,
                   help="Evaluate only checkpoints whose step is divisible "
                   "by this integer (0: every checkpoint).")
    p.add_argument("--data_fake_dataset", type=_bool, nargs="?", const=True,
                   default=False,
                   help="Replace the real data by a fake dataset.")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and evaluate on (cuda, "
                   "cuda:1, cpu).")
    p.add_argument("--num_devices", type=int, default=None,
                   help="Data-parallel workers on this host, one per device "
                   "(default: every local CUDA device; one on the CPU).")
    p.add_argument("--use_tpu", type=_bool, nargs="?", const=True,
                   default=None,
                   help="Accepted for compatibility with the reference CLI; "
                   "ignored.")
    p.add_argument("--multihost", type=_bool, nargs="?", const=True,
                   default=False,
                   help="Run as one host of a data-parallel group of "
                   "--num_processes hosts.")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of the group's rendezvous (--multihost).")
    p.add_argument("--num_processes", type=int, default=None,
                   help="Hosts in the group (--multihost).")
    p.add_argument("--process_id", type=int, default=None,
                   help="This host's index among them (--multihost).")
    return p


@gin.configurable("run_config")
def _get_run_config(model_dir, device, iterations_per_loop=100,
                    save_checkpoints_steps=5000, keep_checkpoint_max=1000,
                    tf_random_seed=None, profile=False):
    """Gin-configurable run config (same binding names as the JAX
    binary's `run_config.*`; `profile` traces the second loop of
    training)."""
    return runner_lib.RunConfig(
        model_dir=model_dir, tf_random_seed=tf_random_seed,
        iterations_per_loop=iterations_per_loop,
        save_checkpoints_steps=save_checkpoints_steps,
        keep_checkpoint_max=keep_checkpoint_max, device=device,
        profile=profile)


@dataclasses.dataclass(frozen=True)
class _Launch:
    """A data-parallel launch: this host's place and its workers."""
    num_hosts: int
    host_id: int
    local_count: int
    address: str
    port: int


def _launch(args):
    """The data-parallel launch the flags ask for, or None for one process
    without a group."""
    device = torch.device(args.device)
    all_local = (max(torch.cuda.device_count(), 1)
                 if device.type == "cuda" and device.index is None else 1)
    if args.multihost:
        missing = [f"--{name}" for name in ("coordinator_address",
                                            "num_processes", "process_id")
                   if getattr(args, name) is None]
        if missing:
            raise ValueError(f"--multihost needs {', '.join(missing)}.")
        if not 0 <= args.process_id < args.num_processes:
            raise ValueError(f"--process_id={args.process_id} is not one of "
                             f"{args.num_processes} processes.")
        address, port = args.coordinator_address.rsplit(":", 1)
        local = all_local if args.num_devices is None else args.num_devices
        mesh_utils.check_device_count(local, device)
        return _Launch(args.num_processes, args.process_id, local, address,
                       int(port))
    if args.num_devices is None and all_local == 1:
        return None
    local = all_local if args.num_devices is None else args.num_devices
    mesh_utils.check_device_count(local, device)
    return _Launch(1, 0, local, "127.0.0.1", mesh_utils.free_port())


def _run(args, device, replicas=None):
    """Parse the gin config and run the schedule on `device` (as one worker
    of a data-parallel group with `replicas`)."""
    logger.info("Gin config: %s\nGin bindings: %s", args.gin_config,
                args.gin_bindings)
    datasets.set_fake_dataset(args.data_fake_dataset)
    gin.parse_config_files_and_bindings(args.gin_config, args.gin_bindings)
    run_config = _get_run_config(args.model_dir, device)
    score_file = (os.path.join(args.model_dir, args.score_filename)
                  if args.score_filename else None)
    task_manager = runner_lib.TaskManagerWithCsvResults(
        model_dir=args.model_dir, score_file=score_file)
    options = runner_lib.get_options_dict()
    report = runner_lib.run_with_schedule(
        schedule=args.schedule, run_config=run_config,
        task_manager=task_manager, options=options,
        num_eval_averaging_runs=args.num_eval_averaging_runs,
        eval_every_steps=args.eval_every_steps or None, replicas=replicas)
    logger.info("Finished schedule %s.", args.schedule)
    return report


def _worker(local_rank, args, launch, log_level=None):
    """One data-parallel worker: join the group, run the schedule."""
    rank = launch.host_id * launch.local_count + local_rank
    world = launch.num_hosts * launch.local_count
    if log_level is not None:  # A spawned worker configures its own.
        logging.basicConfig(
            level=log_level,
            format=f"%(asctime)s rank {rank} %(levelname)s %(message)s")
    device = mesh_utils.worker_device(args.device, local_rank,
                                      launch.local_count)
    replicas = mesh_utils.init_process_group(
        rank, world, launch.address, launch.port, device,
        num_hosts=launch.num_hosts)
    logger.info("Worker rank %d of %d on %s (host %d of %d).", rank, world,
                device, launch.host_id, launch.num_hosts)
    try:
        return _run(args, str(device), replicas)
    finally:
        mesh_utils.destroy_process_group()


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the schedule. Returns
    its TrainReport (training, and the records of evaluated checkpoints)
    when it ran in this process; None when spawned workers ran it."""
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    launch = _launch(args)
    if launch is None:
        return _run(args, args.device)
    if launch.local_count == 1:
        return _worker(0, args, launch)
    torch.multiprocessing.start_processes(
        _worker, args=(args, launch, logging.getLogger().getEffectiveLevel()),
        nprocs=launch.local_count, join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
