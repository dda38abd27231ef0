"""Hand-written CUDA kernels of the device path, each beside its plain
PyTorch version:

``expr_vm``     K2/K3 — the expression VM (filter mask, group keys and
                aggregate inputs of a scan-aggregate fragment; with an
                epilogue, K5a's finish of a join's ON residual);
``groupby_agg`` K1 — the masked GROUP BY aggregate;
``sort_topk``   K4 — multi-key sort for top-k and group order, and the
                whole valid-first key order of a sort join;
``join_probe``  K5a — the join probe (key packing, dense/sorted index
                lookup, unique / count / existence modes);
``join_expand`` K5b — the CSR expansion, post-join compaction and join
                totals (a hand-written scan);
``join_match``  K7 — the standalone join match: the build side indexed
                on the card in K6's layout, a unique dense build probed
                and its pairs compacted in one launch;
``merge_states`` K8/K9 — the fold of partial aggregate states (the
                streamed aggregate's, the paged and hybrid joins', the
                mesh's): one merge of the states' sorted live runs;
``window_scan`` K10 — window functions after the window's sort (K4):
                change flags, segmented scans of the partition and
                peer-group bounds and running aggregates, and the
                scatter back to input order;
``radix_exchange`` kernel A of the MPP exchange (K11/K12) — the mix64
                destination hash and the stable two-level radix
                partition of a shard's rows into the slot grid the
                mesh's all_to_all splits;
``shuffle_join`` kernel B of the MPP shuffle join (K11) — the local
                sort join's sum: prefix sums of the build values in K4's
                order, each probe row's match sum over K5a's range, and
                a fixed-order reduction of the total and the pairs.

Sources live in ``csrc/``; ``build.py`` compiles them with nvcc for
sm_90a into one shared library at first use.  A wrapper launches its
kernel for CUDA tensors and runs the plain version for CPU tensors; each
counts its kernel launches in ``LAUNCHES``.
"""
