"""Delta pair generation for streaming tSPM+ (``csrc/tspm_delta.cu``)."""
