"""The card's peaks and the operations and bytes of the kernels and of a
whole training iteration, counted from shapes alone."""
