"""Every model family: layers, attention (paged, windowed, int8 KV,
cross), routed experts, Mamba2, xLSTM cells, the Model module."""
