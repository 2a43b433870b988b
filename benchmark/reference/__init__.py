"""The plain reference of the benchmark: plain PyTorch, float32 with the
rounding the configuration states made explicit, importing nothing of the
program. It is handed the inputs the benchmark made and works out again
what the program derives from them.
"""
