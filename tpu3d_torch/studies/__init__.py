"""tpu3d_torch.studies — the paper's experiments on the port: the
statistical-normalization effect, the Cyclist class and the cross-domain
matrix (the port's copies of ``examples/statnorm_effect.py``,
``multiclass_cyclist.py`` and ``domain_matrix.py``). Each builds its
synthetic domains from seeds, converts them with ``stat_norm``, trains and
evaluates through the port's CLIs in subprocesses and scores with
``evaluate``:

    python -m tpu3d_torch.studies.statnorm_effect --out DIR [--device cpu]
"""
