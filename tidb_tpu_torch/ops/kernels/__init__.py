"""Hand-written CUDA kernels of the device path, each beside its plain
PyTorch version:

``expr_vm``     K2/K3 — the expression VM (filter mask, group keys and
                aggregate inputs of a scan-aggregate fragment);
``groupby_agg`` K1 — the masked GROUP BY aggregate;
``sort_topk``   K4 — multi-key sort for top-k and group order, and the
                whole valid-first key order of a sort join;
``join_probe``  K5a — the join probe (key packing, dense/sorted index
                lookup, unique / count / existence modes);
``join_expand`` K5b — the CSR expansion, post-join compaction and join
                totals (a hand-written scan);
``merge_states`` K8/K9 — the fold of partial aggregate states (the
                streamed aggregate's and the paged join's): a gather
                of each state's live slots, then K1's kernels;
``window_scan`` K10 — window functions after the window's sort (K4):
                change flags, segmented scans of the partition and
                peer-group bounds and running aggregates, and the
                scatter back to input order.

Sources live in ``csrc/``; ``build.py`` compiles them with nvcc for
sm_90a into one shared library at first use.  A wrapper launches its
kernel for CUDA tensors and runs the plain version for CPU tensors; each
counts its kernel launches in ``LAUNCHES``.
"""
