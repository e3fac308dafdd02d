"""The yardstick: operations, bytes, peaks and the camera ring, copied from
the program at commit e2e15df8eb5b1f9149d8000ecb6c575b37fbec06 so that a
later change to the program cannot move it."""
