"""The H100 benchmark of the PyTorch port (targetvae_tpu_torch).

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json. Everything a cell needs is
found by name: its configuration in configs/, its traffic mix in traffic/,
each per-layer metric's reader in metrics/, the limits of its correctness
check in limits/. The yardstick (counts/, reference/, generate.py,
judge.py) is the benchmark's own: it imports neither JAX nor the JAX
package, and the reference imports nothing of the port.
"""
