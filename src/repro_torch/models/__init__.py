"""Dense and MoE decoder families: layers, attention (paged, windowed, int8 KV), routed experts, the Model module."""
