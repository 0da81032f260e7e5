"""The benchmark's harness: finding a cell's pieces, the traffic loop,
the trace reading and the output check."""
