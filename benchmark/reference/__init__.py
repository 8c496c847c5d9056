"""The plain references the benchmark judges the program against: plain
PyTorch and numpy, fp32 with TF32 off, importing nothing of the program."""
