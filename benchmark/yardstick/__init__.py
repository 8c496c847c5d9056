"""The benchmark's frozen yardstick: the cost model of the chain kernels
and of each unit of work, the card's published peaks, the split of a
profiler trace by kernel, and the statistics of a measured window."""
