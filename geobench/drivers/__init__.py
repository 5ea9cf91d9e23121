"""Loop kinds: each module's `run(ctx)` sets a cell up, measures its window
and returns an `Outcome` with the answers judged."""
