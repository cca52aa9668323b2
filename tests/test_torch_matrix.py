"""The PATHWAY_THREADS matrix of the port (``tests/test_matrix.py``'s
pattern): ``tests/test_torch_table_parity.py`` re-runs with
``PATHWAY_THREADS=4``, so its captures come from the port's 4-shard data
plane (``run_tables_sharded``) and its ``pw.run`` cases from
``ClusterRunner``, each still held to the JAX package's single-shard
output.

One case is left out: ``test_columnar_join_runs_the_device_membership``
counts the join's device membership pre-filter, which takes a columnar
batch of 1,024 rows or more; the cluster's router splits each batch into
per-shard row lists (as the JAX package's does), so that tier does not
run sharded.  Its output is covered by the other join cases.  Nor is
``test_pw_run_refuses_several_processes`` run again: it spawns its own
cluster, and the spawn sets ``PATHWAY_THREADS`` for its processes, so
here it would repeat the same run."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_table_parity_under_threads_4():
    env = dict(os.environ)
    env["PATHWAY_THREADS"] = "4"
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "tests/test_torch_table_parity.py",
         "-k", "not test_columnar_join_runs_the_device_membership and "
         "not test_pw_run_refuses_several_processes"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, (
        f"PATHWAY_THREADS=4 leg failed:\n{res.stdout[-4000:]}\n"
        f"{res.stderr[-2000:]}")
    assert " passed" in res.stdout and "failed" not in res.stdout
