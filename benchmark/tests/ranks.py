"""One rank of a two-rank training run on the CPU (gloo), for
``test_bench_ranks.py``: ``python -m benchmark.tests.ranks RANK WORLD PORT
FAULT`` prints rank 0's checks as one JSON line. FAULT ``exchange`` leaves
out the gradients' all-reduce; ``control`` runs the plain reference on
every rank in the program's place (TF32 is nothing on the CPU, so there it
agrees with the reference)."""

import json
import os
import sys

import torch


def main(rank, world, port, fault):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    import torch.distributed as dist
    from selfc_tpu_torch.parallel.dist import init_distributed

    from benchmark import faults
    from benchmark.drivers import train_step
    from benchmark.tests.tiny import correct, tiny_run

    init_distributed("cpu")
    r = tiny_run("gmm4x.train.b8", seconds=0.5)
    r.rank, r.world = rank, world
    r.cfg["datasets"]["train"]["batch_size"] = 2 * len(r.cfg["gpu_ids"])     # 2 clips a rank
    if fault == "exchange":
        r.make_program = lambda run, tree: faults.NoExchange(train_step.program(run, tree))
    elif fault == "control":
        r.make_program = train_step.Control
    res = train_step.run(r)
    if rank == 0:
        print(json.dumps({"correct": correct(r, res), "checks": res["checks"]}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
