"""Training: AdamW (``optimizer``), the train step (``train_loop``),
checkpoints (``checkpoint``) and the preemption guard and straggler
watchdog (``elastic``).  ``train_loop.state_pspecs`` gives the train
state's specs on a mesh; the reference's ``reshard`` waits for the sharded
execution on real process groups (ROADMAP queue 1, item 17.5b)."""
