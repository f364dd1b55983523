"""Headline benchmark: prints ONE JSON line on a GPU, fails without one
(see lora_tpu/benchmarks.py for the measurement)."""

from lora_tpu.benchmarks import main

if __name__ == "__main__":
    main()
