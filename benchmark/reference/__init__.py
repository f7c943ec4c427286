"""The plain torch reference: scenes, hits, the bounce loop, the G-buffer
and the a-trous filter, written out here with nothing of the program
under test imported."""
