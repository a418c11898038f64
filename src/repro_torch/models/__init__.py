"""The dense decoder LM over the quantized layers."""
