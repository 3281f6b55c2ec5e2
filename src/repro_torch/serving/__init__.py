"""Slot-based continuous-batching serving of the LM substrate."""
