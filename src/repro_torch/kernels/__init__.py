"""Hand-written Hopper kernels of the port, each module holding a wrapper,
its plain PyTorch version (taken for CPU tensors) and a launch counter:

    sketch_update   fused EMA X/Y/Z update, one pass over A
                    (replaces src/repro/kernels/sketch_update.py)
    psparse_update  the same update with hashed p-sparse projections,
                    reading only their support rows of A
                    (replaces src/repro/kernels/psparse_update.py)
    csvec_insert    count-sketch insert of a flat vector into all r
                    hash rows (replaces src/repro/kernels/csvec_insert.py)
    csvec_topk      top-k coordinates by |median-of-r estimate|
                    (replaces src/repro/kernels/csvec_topk.py)
    csvec_quant     per-row int8 quantisation of the sketch table
                    (replaces src/repro/kernels/csvec_quant.py)
    flash_attention causal / sliding-window GQA attention, forward and
                    backward (replaces src/repro/kernels/
                    flash_attention.py; the backward is the gradient of
                    src/repro/kernels/ref.py::flash_attention_ref)
    mlstm_chunk     chunkwise stabilised mLSTM forward from a zero state
                    (replaces src/repro/kernels/mlstm_chunk.py)
    ring_allreduce  the data-parallel merge of W workers' flat buffers:
                    the pipelined chain's result on an fp32 or int8
                    wire, folded where the W rows lie on one card
                    (replaces src/repro/kernels/ring_allreduce.py)

The package re-exports nothing: a function re-exported under its
module's name would hide the module (``repro_torch.kernels.psparse_update``
would resolve to the function).
"""
