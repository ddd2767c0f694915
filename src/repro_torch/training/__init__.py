"""Checkpoints (``checkpoint``); the rest of the reference's training
package (optimizer, train loop, elastic) waits for the LM side's port
(ROADMAP.md queue 1 item 17)."""
