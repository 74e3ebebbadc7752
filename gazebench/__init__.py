"""gazebench: the benchmark of the MCGaze PyTorch/CUDA port
(mcgaze_tpu_torch) on one H100.

    python3 -m gazebench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
    python3 -m gazebench.control --workload <cell> --seeds <n> ...

BENCHMARK.json at the checkout's root lists the cells, the end-to-end
metrics and their bounds, and the per-layer metrics; spec.py says where
each part of a cell lives. It imports neither JAX nor the JAX package.
"""
