"""Data parallelism of the port: W workers in one process on one device
(counterpart of ``repro.parallel`` for the single-axis data-parallel
step; the reference's mesh sharding is ROADMAP A14).

The reference runs its data-parallel LM step under ``shard_map`` over a
W-device axis, with the train state replicated and the batch split on
its leading axis. The port's machine has one card, NCCL refuses two
ranks on one device, and the reference's own tests and launcher run W
workers on one host; so the port writes the worker axis out, as a
``vmap`` becomes a written batch dimension:

  * the replicated state (parameters, AdamW moments, the sketch tree) is
    held once, which is what lets tinyllama-1.1b's full width fit on one
    card; the per-worker quantities are lists of W or (W, ...) stacks:
    each worker's rows [w B/W, (w+1) B/W) of the batch, its gradients and
    local increments, its count-sketch error feedback ``opt["err"]`` and
    its int8 sketch-wire ledger ``opt["sketch_err"]``;
  * the step (``train.step``) runs the reference's SPMD step in phases
    over the workers: each worker's local phase, the collective, the
    replicated finish computed once, and the per-worker ledger updates.
    ``per_node``, which psums inside the forward, runs as the overlap
    schedule's phases (its merged values are bitwise those) with one
    collective per node leaf. No threads: a barrier between threads
    could hang, and W copies of the replicated update would not fit;
  * a psum is the ordered left fold ``x[0] + x[1] + ... + x[W-1]``,
    XLA:CPU's order, which the fp32 ring kernel reproduces bit for bit;
  * the projections are sized for one worker's tokens, ``global_batch //
    dp_workers * seq_len``, and shared by all workers.

``collectives`` holds the merges and their accounting; the ring
(``kernels.ring_allreduce``) computes the chain's fold over the W
workers' rows where they lie in the card's memory. Transport between
cards (``torch.distributed``/NCCL
process groups, a ring over peer memory) waits for a machine with more
than one card.
"""
