"""What the port carries of gpt2_vision_language_tpu/parallel: the process
mesh and the ring handle (``mesh``), the collectives of data and tensor
parallelism (``collectives``), and the Megatron split with sequence
parallelism (``sharding``). The GPipe pipeline is not ported yet."""
