"""Training: AdamW (``optimizer``), the train step (``train_loop``),
checkpoints (``checkpoint``) and the preemption guard and straggler
watchdog (``elastic``).  The reference's ``state_pspecs`` and ``reshard``
wait for the LM side's sharding (ROADMAP queue 1, item 17)."""
