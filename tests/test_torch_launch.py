"""The port's launcher (``paddle_tpu_torch/distributed/launch.py``) and the
data-parallel feed rule: each rank's environment, the OR of the ranks'
exit codes, a rank that outlives ``--timeout`` killed with a failing
exit, and the global batch sliced per rank (a leading dim that does not
divide raises).  Small scripts on the CPU; no process group."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import launch as L
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops.collective_ops import (DataParallelGroup,
                                                 slice_feed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
        "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "FLAGS_selected_gpus",
        "PADDLE_DISTRI_BACKEND")


def _script(tmp_path, body):
    path = tmp_path / "rank.py"
    path.write_text("import os, sys, time\n" + body)
    return str(path)


def test_each_rank_gets_its_environment(tmp_path):
    script = _script(tmp_path, (
        "keys = %r\n"
        "with open(os.path.join(sys.argv[1], os.environ['RANK']), 'w') as f:\n"
        "    f.write(repr({k: os.environ.get(k) for k in keys}))\n") % (KEYS,))
    rc = L.launch([script, str(tmp_path)], nproc=3, selected_gpus="0,1,2",
                  backend="gloo", timeout=60)
    assert rc == 0
    envs = [eval((tmp_path / str(r)).read_text()) for r in range(3)]
    port = envs[0]["MASTER_PORT"]
    assert int(port) > 0
    for r, env in enumerate(envs):
        assert env == {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                       "RANK": str(r), "WORLD_SIZE": "3",
                       "LOCAL_RANK": str(r), "PADDLE_TRAINER_ID": str(r),
                       "PADDLE_TRAINERS_NUM": "3",
                       "FLAGS_selected_gpus": str(r),
                       "PADDLE_DISTRI_BACKEND": "gloo"}


def test_one_gpu_id_is_shared_and_a_wrong_count_refused():
    assert L._gpu_ids("0", 2) == ["0", "0"]
    assert L._gpu_ids(None, 2) is None
    with pytest.raises(SystemExit, match="one per rank"):
        L._gpu_ids("0,1,2", 2)


def test_the_exit_code_is_the_or_of_the_ranks(tmp_path):
    script = _script(tmp_path, "sys.exit({0: 0, 1: 1, 2: 2}"
                               "[int(os.environ['RANK'])])\n")
    assert L.launch([script], nproc=3, timeout=60) == 3
    ok = _script(tmp_path, "sys.exit(0)\n")
    assert L.launch([ok], nproc=2, timeout=60) == 0


def test_a_rank_that_outlives_the_timeout_is_killed(tmp_path):
    script = _script(tmp_path, "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--timeout", "2", script], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert rc.returncode != 0
    assert "still running after 2.0 s" in rc.stderr
    assert time.monotonic() - t0 < 30


def test_a_failed_rank_ends_the_launch_without_waiting_for_the_timeout(
        tmp_path):
    script = _script(tmp_path, "if os.environ['RANK'] == '1':\n"
                               "    sys.exit(5)\n"
                               "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = L.launch([script], nproc=2, timeout=100)
    assert rc & 5 == 5
    assert time.monotonic() - t0 < L.FAILURE_GRACE_S + 20


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3)])
def test_each_rank_keeps_its_rows_of_the_global_batch(world, rank):
    dp = DataParallelGroup(rank, world, "gloo")
    batch = np.arange(8 * 3).reshape(8, 3)
    rows = 8 // world
    want = batch[rank * rows:(rank + 1) * rows]
    assert np.array_equal(slice_feed(dp, "x", batch), want)
    got = slice_feed(dp, "x", torch.from_numpy(batch))
    assert torch.equal(got, torch.from_numpy(want))
    assert slice_feed(None, "x", batch) is batch      # outside a group
    assert slice_feed(dp, "lr", np.float32(0.5)) == np.float32(0.5)


def test_a_batch_that_does_not_divide_over_the_ranks_raises():
    dp = DataParallelGroup(0, 3, "gloo")
    with pytest.raises(InvalidArgumentError,
                       match="leading dim 8 does not divide into 3"):
        slice_feed(dp, "src_ids", np.zeros((8, 4)))
