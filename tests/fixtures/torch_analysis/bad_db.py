"""Known-bad: direct sqlite3 outside the DB access layer."""
import sqlite3


def open_db(path):
    return sqlite3.connect(path)
