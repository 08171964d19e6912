"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: every width and count shrunk, the same code paths."""

import time

from portbench import harness

TINY_CONFIG = dict(n_levels=4, log2_hashmap_size=12, grid_size=32,
                   batch_size=256, img_wh=[32, 32], n_train_views=4,
                   warmup_steps=32, update_interval=16, gt_samples=64)
TINY_TRAFFIC = dict(img_wh=[32, 32], trace_blocks=2, trace_views=2,
                    orbit_views=6)
# the card's fused head takes the published widths only (16 levels x 2)
CARD_WIDTHS = dict(n_levels=16, log2_hashmap_size=19)


def cell(name: str, root=harness.HERE, card: bool = False) -> harness.Cell:
    c = harness.Cell(name, root=root)
    c.config.update(TINY_CONFIG, **(CARD_WIDTHS if card else {}))
    c.traffic.update(TINY_TRAFFIC)
    return c


def run(c: harness.Cell, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: int = 0, ranks=None, device: str = "cpu"):
    """One run of the cell on `device`: (result line, the driver's out)."""
    args = harness.parse(["--workload", c.name, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    out = c.driver().run(c, args, ranks or harness.Ranks(1, []),
                         time.perf_counter(), device)
    if not out:                       # a rank other than 0
        return None, out
    return harness.result_line(c, out, trace)[0], out


# faults planted in the program, by name (applied inside each rank)
def _fault_state_unchanged():
    from arnerf_tpu_torch.training import trainer
    trainer.Adam.step = lambda self, params, grads: None


def _fault_half_batch():
    from arnerf_tpu_torch.training import trainer
    orig = trainer.nerf_loss

    def half(results, rgb_gt, cfg):
        return {k: v[: v.shape[0] // 2] for k, v in
                orig(results, rgb_gt, cfg).items()}
    trainer.nerf_loss = half


def _fault_no_exchange():
    from arnerf_tpu_torch.training import trainer
    trainer.join_step = lambda leaves, grads, metrics, mesh, tp=None: \
        (list(grads), metrics)


def _render_fault(change):
    from arnerf_tpu_torch import rendering
    orig = rendering.render_test

    def faulty(*a, **k):
        out = dict(orig(*a, **k))
        out["rgb"] = change(out["rgb"].clone())
        return out
    rendering.render_test = faulty


def _fault_answer_altered():
    def change(rgb):
        rgb[: rgb.shape[0] // 8] += 0.25
        return rgb
    _render_fault(change)


def _fault_half_rays():
    def change(rgb):
        rgb[rgb.shape[0] // 2:] = 0.0
        return rgb
    _render_fault(change)


def _fault_encode_hash():
    from arnerf_tpu_torch.ops import hashgrid
    hashgrid._PRIME_Y, hashgrid._PRIME_Z = hashgrid._PRIME_Z, \
        hashgrid._PRIME_Y


FAULTS = {"state_unchanged": _fault_state_unchanged,
          "half_batch": _fault_half_batch,
          "no_exchange": _fault_no_exchange,
          "answer_altered": _fault_answer_altered,
          "half_rays": _fault_half_rays,
          "encode_hash": _fault_encode_hash}


def _rank_main(name, rank, world, port, fault, seed, queue):
    import os
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), PORTBENCH_RANK=str(rank),
                      OMP_NUM_THREADS="1")
    import torch
    torch.set_num_threads(1)
    if fault:
        FAULTS[fault]()
    line, _ = run(cell(name), seed=seed,
                  ranks=harness.Ranks(world, []))
    if rank == 0:
        queue.put(line)


def run_ranks(name: str, world: int, fault: str = None,
              seed: int = 2 ** 31 + 11, timeout: float = 240.0) -> dict:
    """A cell on `world` CPU processes over gloo; rank 0's result line."""
    import multiprocessing as mp
    import socket
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(name, r, world, port, fault, seed, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        line = q.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return line
