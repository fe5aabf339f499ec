"""MX codec, block quantization, policy, pack-once store and mx_dot."""
