"""What the port carries of gpt2_vision_language_tpu/parallel: the process
group and the ring handle of ring attention (``mesh``). Data parallelism,
Megatron tensor parallelism, sequence parallelism and the pipeline are not
ported yet."""
