"""Model construction from a config (training itself: ROADMAP.md Queue 1)."""
