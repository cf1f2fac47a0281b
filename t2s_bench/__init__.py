"""The benchmark of tacotron2_subword_tpu_torch on one CUDA card.

    python3 -m t2s_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m t2s_bench.control --workload <cell> --seeds <n> ...
    python3 -m pytest t2s_bench/tests            # on the CPU; -m cuda on a card

``BENCHMARK.json`` at the repository's root names the cells, configurations
and metrics; ``layout`` finds each by that name.  Nothing here imports JAX
or the JAX package; only ``system/`` imports the program.
"""
