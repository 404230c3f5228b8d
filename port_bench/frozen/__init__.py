"""Frozen copies of the program's yardstick pieces, as of commit 15a5d0c."""
