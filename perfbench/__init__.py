"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``README.md``).
Nothing here imports JAX or the JAX package; the references under
``reference/`` import nothing of the program either.
"""
