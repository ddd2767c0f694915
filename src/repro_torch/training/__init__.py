"""Training: AdamW (``optimizer``), the train step (``train_loop``),
checkpoints (``checkpoint``, sharded states included) and the preemption
guard, re-meshing and straggler watchdog (``elastic``).
``train_loop.state_pspecs`` gives the train state's specs on a mesh;
``elastic.reshard`` places a state by them."""
