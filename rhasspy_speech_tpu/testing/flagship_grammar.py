"""The flagship grammar: a voice-assistant template set, committed as data.

Intents over device-name and area lists: on/off, brightness and
temperature ranges, covers and locks, timers, and questions — the same
class of grammar as a home-assistant sentence file. Its expansion count
and graph sizes are pinned by tests/test_flagship_grammar.py.
"""

FLAGSHIP_GRAMMAR = {
    "language": "en",
    "sentences": [
        # lights and switches by name
        "turn (on|off) [the] {name}",
        "turn [the] {name} (on|off)",
        "switch (on|off) [the] {name}",
        "is [the] {name} (on|off)",
        # lights by area
        "turn (on|off) [the] (light|lights) in [the] {area}",
        # brightness
        "set [the] {name} brightness to {brightness} percent",
        "set [the] {name} to {brightness} percent",
        "set [the] {area} (light|lights) to {brightness} percent",
        # climate
        "set [the] temperature to {temperature} degrees",
        "set [the] thermostat to {temperature} [degrees]",
        "set [the] {area} temperature to {temperature} [degrees]",
        "what is the temperature [in [the] {area}]",
        # covers and locks
        "(open|close) [the] {cover}",
        "(lock|unlock) [the] {lock}",
        # timers
        "set [a] timer for {minutes} minutes",
        "cancel [the] timer",
        # questions and small talk
        "what time is it",
        "what is the (time|date)",
        "never mind",
    ],
    "lists": {
        "name": {
            "values": [
                "kitchen light",
                "kitchen lights",
                "living room lamp",
                "bedroom lamp",
                "bedroom light",
                "garage light",
                "tv",
                "heater",
            ]
        },
        "area": {
            "values": [
                "kitchen",
                "living room",
                "bedroom",
                "bathroom",
                "garage",
                "office",
                "basement",
                "hallway",
                "dining room",
            ]
        },
        "cover": {
            "values": [
                "garage door",
                "curtains",
                "window",
            ]
        },
        "lock": {"values": ["front door", "back door", "side gate"]},
        "brightness": {"range": {"from": 0, "to": 100, "step": 5}},
        "temperature": {"range": {"from": 45, "to": 90}},
        "minutes": {"range": {"from": 1, "to": 10}},
    },
}
