"""Host utilities: the safetensors reader, the weight converters, tracing and
NaN checks (`profiling`), TensorBoard logging (`tb`) and figures (`viz`)."""
