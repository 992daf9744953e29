"""Host-side helpers of the port (numpy only): PLY export, the window
prefetcher and the stage timer."""
