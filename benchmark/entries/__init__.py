"""One module per traffic entry (`"entry"` in a traffic file): what a cell's
window drives, how it is timed and how its output is checked."""
