"""The port's benchmark: BENCHMARK.json's harness, its plain reference and their tests."""
